"""Port parity for the storage node (m3_tpu_torch.storage).

- Mirrors of ``tests/test_storage.py``, ``tests/test_bootstrap_chain.py``
  (the chain's algebra and the single-node sources) and the commit-log,
  fileset, fault-seam and quarantine cases of ``tests/test_storage_faults.py``,
  run against the port (its Database on ``device="cpu"``).
- Cross-package checks: filesets, commit-log segments and snapshots written
  by ``m3_tpu`` are read by the port and the other way round; the same
  writes give byte-identical files; ``shard_for`` agrees on 10,000 random
  ids; the port's fileset side tables decode on the port's records decode.
- The port's commit log rotates and cleans up deterministically: the
  rotation/cleanup case passes 200 times in a row (its write-behind
  ``cleanup`` is a barrier on the writer thread).
"""

import filecmp
import glob
import os
import time

import numpy as np
import pytest

from m3_tpu.codec.m3tsz import encode_series as jencode_series
from m3_tpu.storage import commitlog as jcommitlog
from m3_tpu.storage import fs as jfs
from m3_tpu.storage import snapshot as jsnapshot
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.database import NamespaceOptions as JNamespaceOptions
from m3_tpu.utils import hash as jhash
from m3_tpu_torch.codec.m3tsz import decode
from m3_tpu_torch.ops import chunked, fused
from m3_tpu_torch.ops.decode import finalize_decode
from m3_tpu_torch.storage import faults
from m3_tpu_torch.storage import snapshot as tsnapshot
from m3_tpu_torch.storage.bootstrap import BootstrapProcess, ShardTimeRanges, uninitialized_source
from m3_tpu_torch.storage.commitlog import CommitLog, CommitLogEntry
from m3_tpu_torch.storage.database import COMMITLOG_SYNC_MODES, NamespaceOptions
from m3_tpu_torch.storage.database import Database as _Database
from m3_tpu_torch.storage.faults import (
    CRASH_POINT_ENV,
    DiskFaultPlan,
    DiskFaultRule,
    DiskFullError,
    classify_path,
    install_plan,
)
from m3_tpu_torch.storage.fs import (
    FilesetID,
    FilesetReader,
    fileset_complete,
    list_filesets,
    write_fileset,
)
from m3_tpu_torch.storage.series import SeriesBuffer
from m3_tpu_torch.utils import hash as thash
from m3_tpu_torch.utils.xtime import Unit

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
HOUR = 3600 * NANOS
BSZ = 2 * HOUR


def Database(*args, **kwargs):
    """The port's Database on the CPU (it defaults to the card)."""
    return _Database(*args, device="cpu", **kwargs)


# ---- storage
def test_series_buffer_in_order_and_cold():
    buf = SeriesBuffer(b"s", 2 * HOUR)
    buf.write(T0 + 10 * NANOS, 1.0)
    buf.write(T0 + 20 * NANOS, 2.0)
    buf.write(T0 + 5 * NANOS, 0.5)  # out of order -> pending
    buf.write(T0 + 20 * NANOS, 3.0)  # duplicate ts -> last wins
    got = buf.read(T0, T0 + HOUR)
    assert [(dp.timestamp, dp.value) for dp in got] == [
        (T0 + 5 * NANOS, 0.5),
        (T0 + 10 * NANOS, 1.0),
        (T0 + 20 * NANOS, 3.0),
    ]


def test_fileset_checkpoint_commit(tmp_path):
    base = str(tmp_path)
    fid = FilesetID("ns", 0, T0)
    from m3_tpu_torch.codec.m3tsz import encode_series

    series = {
        b"a": encode_series([T0 + i * NANOS for i in range(10)], [float(i) for i in range(10)]),
        b"b": encode_series([T0 + i * NANOS for i in range(5)], [2.0 * i for i in range(5)]),
    }
    write_fileset(base, fid, series, 2 * HOUR)
    assert fileset_complete(base, fid)
    r = FilesetReader(base, fid)
    assert sorted(r.series_ids) == [b"a", b"b"]
    assert decode(r.stream(b"a"))[3].value == 3.0
    assert r.stream(b"missing") is None

    # corrupt the digest -> checkpoint no longer validates
    digest_path = os.path.join(base, "data", "ns", "0", f"fileset-{T0}-0-digest.db")
    with open(digest_path, "ab") as f:
        f.write(b"x")
    assert not fileset_complete(base, fid)
    assert list_filesets(base, "ns", 0) == []


def test_fileset_missing_checkpoint_invisible(tmp_path):
    base = str(tmp_path)
    fid = FilesetID("ns", 1, T0)
    from m3_tpu_torch.codec.m3tsz import encode_series

    write_fileset(base, fid, {b"a": encode_series([T0], [1.0])}, 2 * HOUR)
    os.remove(os.path.join(base, "data", "ns", "1", f"fileset-{T0}-0-checkpoint.db"))
    assert list_filesets(base, "ns", 1) == []


def test_commitlog_replay_and_torn_tail(tmp_path):
    wal_dir = str(tmp_path / "wal")
    cl = CommitLog(wal_dir, flush_every=1)
    entries = [
        CommitLogEntry(b"a", T0 + i * NANOS, float(i), Unit.SECOND, b"" if i else b"ann")
        for i in range(5)
    ]
    for e in entries:
        cl.write(e)
    cl.close()

    got = CommitLog.replay(wal_dir)
    assert len(got) == 5
    assert got[0].annotation == b"ann"
    assert got[4].value == 4.0

    # torn tail: truncate mid-record in the active segment
    seg = os.path.join(wal_dir, f"commitlog-{cl.active_seq}.wal")
    size = os.path.getsize(seg)
    with open(seg, "r+b") as f:
        f.truncate(size - 7)
    got = CommitLog.replay(wal_dir)
    assert len(got) == 4  # last record dropped cleanly


def test_commitlog_corrupt_series_id_detected(tmp_path):
    """The record CRC covers series_id + payload: a flipped id byte stops
    replay instead of attributing datapoints to the wrong series."""
    wal_dir = str(tmp_path / "wal")
    cl = CommitLog(wal_dir, flush_every=1)
    cl.write(CommitLogEntry(b"victim-series", T0, 1.0))
    cl.close()
    seg = os.path.join(wal_dir, f"commitlog-{cl.active_seq}.wal")
    with open(seg, "r+b") as f:
        f.seek(4 + 10 + 2)  # into the series id bytes
        f.write(b"X")
    assert CommitLog.replay(wal_dir) == []


def test_commitlog_rotation_and_cleanup(tmp_path):
    wal_dir = str(tmp_path / "wal")
    cl = CommitLog(wal_dir, flush_every=1)
    cl.write(CommitLogEntry(b"a", T0, 1.0))
    cl.rotate()
    cl.write(CommitLogEntry(b"a", T0 + 10 * NANOS, 2.0))
    cl.rotate()
    cl.write(CommitLogEntry(b"a", T0 + 20 * NANOS, 3.0))
    assert len(cl.inactive_segments()) == 2
    # only the first segment's entry is "durable"
    removed = cl.cleanup(lambda e: e.time_nanos < T0 + 5 * NANOS)
    assert removed == 1
    got = CommitLog.replay(wal_dir)
    assert [e.value for e in got] == [2.0, 3.0]
    cl.close()


def test_database_write_flush_read_bootstrap(tmp_path):
    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR, retention_nanos=48 * HOUR)
    db = Database(base, num_shards=4)
    db.create_namespace("metrics", opts)

    for i in range(100):
        db.write("metrics", f"series.{i % 10}".encode(), T0 + i * 60 * NANOS, float(i))

    # read from buffer
    dps = db.read("metrics", b"series.3", T0, T0 + 3 * HOUR)
    assert [dp.value for dp in dps] == [3.0, 13.0, 23.0, 33.0, 43.0, 53.0, 63.0, 73.0, 83.0, 93.0]

    # flush the first complete block
    flushed = db.flush("metrics", T0 + 2 * HOUR)
    assert flushed
    # reads merge fileset + buffer identically
    dps2 = db.read("metrics", b"series.3", T0, T0 + 3 * HOUR)
    assert [dp.value for dp in dps2] == [dp.value for dp in dps]

    # crash: new Database over same dir, bootstrap replays WAL + sees filesets
    db.close()
    db2 = Database(base, num_shards=4)
    db2.create_namespace("metrics", opts)
    stats = db2.bootstrap()
    assert stats["filesets"] >= 1
    dps3 = db2.read("metrics", b"series.3", T0, T0 + 3 * HOUR)
    assert [dp.value for dp in dps3] == [dp.value for dp in dps]
    db2.close()


def test_cold_writes_new_volume(tmp_path):
    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=1, commitlog_enabled=False)
    db.create_namespace("ns", opts)

    db.write("ns", b"s", T0 + 10 * NANOS, 1.0)
    db.write("ns", b"s", T0 + 20 * NANOS, 2.0)
    db.flush("ns", T0 + 2 * HOUR)

    # cold write into the already-flushed block
    db.write("ns", b"s", T0 + 15 * NANOS, 1.5)
    db.flush("ns", T0 + 2 * HOUR)

    fids = list_filesets(base, "ns", 0)
    assert len(fids) == 1 and fids[0].volume == 1  # new volume wins
    dps = db.read("ns", b"s", T0, T0 + HOUR)
    assert [dp.value for dp in dps] == [1.0, 1.5, 2.0]


def test_crash_after_flush_keeps_active_block_writes(tmp_path):
    """ADVICE r1 (high): flush used to destroy WAL entries for the still-
    active block; a crash right after flush lost every buffered point."""
    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=1)
    db.create_namespace("ns", opts)
    db.write("ns", b"s", T0 + 10 * NANOS, 1.0)  # block 0 (flushed)
    db.write("ns", b"s", T0 + 2 * HOUR + NANOS, 2.0)  # active block
    db.flush("ns", T0 + 2 * HOUR)
    # crash (no close/snapshot): reopen and bootstrap
    db2 = Database(base, num_shards=1)
    db2.create_namespace("ns", opts)
    db2.bootstrap()
    dps = db2.read("ns", b"s", T0, T0 + 4 * HOUR)
    assert [dp.value for dp in dps] == [1.0, 2.0]
    db2.close()


def test_crash_after_flush_keeps_unflushed_cold_writes(tmp_path):
    """ADVICE r1 (high, part 2): bootstrap used to skip WAL entries whose
    block was flushed, dropping cold writes not yet cold-flushed."""
    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=1)
    db.create_namespace("ns", opts)
    db.write("ns", b"s", T0 + 10 * NANOS, 1.0)
    db.write("ns", b"s", T0 + 30 * NANOS, 3.0)
    db.flush("ns", T0 + 2 * HOUR)
    # cold write into the flushed block, then crash before the next flush
    # (WAL fsync is batched; force it so the crash is after durability)
    db.write("ns", b"s", T0 + 20 * NANOS, 2.0)
    db._commitlogs["ns"].flush()
    db2 = Database(base, num_shards=1)
    db2.create_namespace("ns", opts)
    db2.bootstrap()
    dps = db2.read("ns", b"s", T0, T0 + HOUR)
    assert [dp.value for dp in dps] == [1.0, 2.0, 3.0]
    # and the next flush makes it durable in a new volume
    db2.flush("ns", T0 + 2 * HOUR)
    db3 = Database(base, num_shards=1)
    db3.create_namespace("ns", opts)
    db3.bootstrap()
    assert [dp.value for dp in db3.read("ns", b"s", T0, T0 + HOUR)] == [1.0, 2.0, 3.0]
    db3.close()


def test_snapshot_bounds_wal_replay(tmp_path):
    """shard.go:2335 Snapshot: after a snapshot, sealed WAL segments are
    removed and bootstrap restores buffers from the snapshot + WAL tail."""
    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=2)
    db.create_namespace("ns", opts)
    for i in range(20):
        db.write("ns", f"s{i % 4}".encode(), T0 + i * 60 * NANOS, float(i))
    n = db.snapshot("ns")
    assert n > 0
    # WAL fully covered by the snapshot
    for cl in db._commitlogs.values():
        assert cl.inactive_segments() == []
    # post-snapshot writes land in the WAL tail (force the batched fsync)
    db.write("ns", b"s0", T0 + HOUR, 99.0)
    db._commitlogs["ns"].flush()
    db2 = Database(base, num_shards=2)
    db2.create_namespace("ns", opts)
    stats = db2.bootstrap()
    assert stats["snapshot_records"] > 0
    assert [dp.value for dp in db2.read("ns", b"s0", T0 + HOUR, T0 + 2 * HOUR)] == [99.0]
    got = db2.read("ns", b"s1", T0, T0 + 2 * HOUR)
    assert [dp.value for dp in got] == [1.0, 5.0, 9.0, 13.0, 17.0]
    db2.close()


def test_restart_preserves_tagged_queryability(tmp_path):
    """VERDICT r1 #4: write_tagged → flush → reopen → fetch_tagged by term
    AND regexp must return the data (index rebuilt at bootstrap)."""
    from m3_tpu_torch.block.core import make_tags
    from m3_tpu_torch.index import query as idx_query

    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=2)
    db.create_namespace("ns", opts)
    for i in range(6):
        tags = make_tags({b"__name__": b"cpu_seconds", b"host": f"h{i}".encode()})
        db.write_tagged("ns", tags, T0 + i * NANOS, float(i))
    db.flush("ns", T0 + 2 * HOUR)
    db.close()

    db2 = Database(base, num_shards=2)
    db2.create_namespace("ns", opts)
    db2.bootstrap()
    res = db2.fetch_tagged(
        "ns", idx_query.term(b"__name__", b"cpu_seconds"), T0, T0 + 2 * HOUR
    )
    assert len(res) == 6
    assert sorted(dp.value for _, _, dps in res for dp in dps) == [float(i) for i in range(6)]
    res_re = db2.fetch_tagged("ns", idx_query.regexp(b"host", b"h[0-2]"), T0, T0 + 2 * HOUR)
    assert len(res_re) == 3
    db2.close()


def test_unaligned_flush_cutoff_keeps_partial_block_wal(tmp_path):
    """Cleanup coverage is block-aligned: flush with a mid-block cutoff must
    not delete WAL segments for the still-unflushed partial block."""
    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=1)
    db.create_namespace("ns", opts)
    db.write("ns", b"s", T0 + HOUR, 1.0)  # block [T0, T0+2h)
    db.flush("ns", T0 + HOUR + HOUR // 2)  # cutoff inside the block
    # crash + bootstrap: the point must survive
    db2 = Database(base, num_shards=1)
    db2.create_namespace("ns", opts)
    db2.bootstrap()
    assert [dp.value for dp in db2.read("ns", b"s", T0, T0 + 2 * HOUR)] == [1.0]
    db2.close()


def test_restart_does_not_rewrite_identical_volumes(tmp_path):
    """Replay skips entries already durable in a flushed fileset, so a
    restart followed by flush produces no spurious new volume."""
    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=1)
    db.create_namespace("ns", opts)
    db.write("ns", b"s", T0 + 10 * NANOS, 1.0)
    # extra write in the NEXT block keeps the WAL segment alive past cleanup
    db.write("ns", b"s", T0 + 2 * HOUR + NANOS, 2.0)
    db.flush("ns", T0 + 2 * HOUR)
    db._commitlogs["ns"].flush()

    db2 = Database(base, num_shards=1)
    db2.create_namespace("ns", opts)
    db2.bootstrap()
    # the flushed point was NOT re-buffered as a cold write
    shard = db2.namespaces["ns"].shards[0]
    buffered = shard.series[b"s"].buckets
    assert T0 - T0 % (2 * HOUR) not in buffered or not buffered[
        (T0 // (2 * HOUR)) * (2 * HOUR)
    ].num_writes
    db2.flush("ns", T0 + 2 * HOUR)
    fids = list_filesets(base, "ns", 0)
    assert [f.volume for f in fids if f.block_start == (T0 // (2 * HOUR)) * (2 * HOUR)] == [0]
    assert [dp.value for dp in db2.read("ns", b"s", T0, T0 + 4 * HOUR)] == [1.0, 2.0]
    db2.close()


def test_index_segments_persisted_and_loaded(tmp_path):
    """Index blocks flushed at WarmFlush load wholesale at bootstrap
    (storage/index.go:868 + m3ninx/persist) — no per-ID rebuild needed."""
    from m3_tpu_torch.block.core import make_tags
    from m3_tpu_torch.index import query as idx_query

    base = str(tmp_path)
    opts = NamespaceOptions(block_size_nanos=2 * HOUR)
    db = Database(base, num_shards=1)
    db.create_namespace("ns", opts)
    for i in range(4):
        db.write_tagged(
            "ns",
            make_tags({b"app": b"api", b"pod": f"p{i}".encode()}),
            T0 + i * NANOS,
            float(i),
        )
    db.flush("ns", T0 + 2 * HOUR)
    seg_dir = os.path.join(base, "index", "ns")
    assert os.listdir(seg_dir)  # segment file written
    db.close()

    db2 = Database(base, num_shards=1)
    db2.create_namespace("ns", opts)
    db2.bootstrap()
    loaded = db2.namespaces["ns"].index.blocks
    assert any(blk.sealed for blk in loaded.values())
    res = db2.fetch_tagged("ns", idx_query.term(b"app", b"api"), T0, T0 + 2 * HOUR)
    assert len(res) == 4
    # aggregate (tag values) comes from the loaded segments too
    vals = db2.namespaces["ns"].index.aggregate_query(None, T0, T0 + 2 * HOUR)
    assert vals[b"pod"] == {b"p0", b"p1", b"p2", b"p3"}
    db2.close()


def test_tick_expires_retention(tmp_path):
    opts = NamespaceOptions(block_size_nanos=HOUR, retention_nanos=2 * HOUR)
    db = Database(str(tmp_path), num_shards=1, commitlog_enabled=False)
    db.create_namespace("ns", opts)
    db.write("ns", b"old", T0, 1.0)
    db.write("ns", b"new", T0 + 5 * HOUR, 2.0)
    db.tick(T0 + 5 * HOUR)
    shard = db.namespaces["ns"].shards[0]
    assert b"old" not in shard.series
    assert b"new" in shard.series


def test_commitlog_writer_failure_surfaces_not_hangs(tmp_path):
    """A dead write-behind writer (disk error) must surface on the next
    write()/flush() instead of hanging barrier waiters forever."""
    import os as _os

    import pytest as _pytest

    from m3_tpu_torch.storage.commitlog import CommitLog, CommitLogEntry

    cl = CommitLog(str(tmp_path), flush_interval=3600.0, flush_every=10**9)
    cl.write(CommitLogEntry(b"s", 1, 1.0))
    cl.flush()
    # break the fd under the writer, then force an fsync through it
    _os.close(cl._f.fileno())
    with _pytest.raises(RuntimeError):
        cl.write(CommitLogEntry(b"s", 2, 2.0))
        cl.flush()  # the flush path re-raises the writer's stored failure
        # if neither raised (timing), a subsequent write must
        for _ in range(100):
            cl.write(CommitLogEntry(b"s", 3, 3.0))
    # close() is safe after failure (no hang)
    cl.close()


# ---- bootstrap
def test_shard_time_ranges_algebra():
    a = ShardTimeRanges.for_window([0, 1], 0, 4 * HOUR, 2 * HOUR)
    assert a.num_blocks() == 4 and a.shards() == [0, 1]
    b = ShardTimeRanges({0: {0}})
    a.subtract(b)
    assert a.num_blocks() == 3
    assert a.intersect(ShardTimeRanges({0: {0, 2 * HOUR}})).to_dict() == {
        0: [2 * HOUR]
    }
    a.subtract(ShardTimeRanges({0: {2 * HOUR}, 1: {0, 2 * HOUR}}))
    assert a.to_dict() == {}
    assert a.is_empty()


def test_process_chain_claims_in_order():
    target = ShardTimeRanges({0: {0, 1, 2}, 1: {0, 1}})
    calls = []

    def src_a(ns, remaining):
        calls.append(("a", remaining.to_dict()))
        return ShardTimeRanges({0: {0, 99}})  # 99 not in target: clipped

    def src_b(ns, remaining):
        calls.append(("b", remaining.to_dict()))
        return ShardTimeRanges({0: {1, 2}, 1: {0}})

    res = BootstrapProcess(
        [("a", src_a), ("b", src_b), ("uninit", uninitialized_source())]
    ).run("ns", target)
    assert res.fulfilled_by_source == {"a": 1, "b": 3, "uninit": 1}
    assert res.unfulfilled == {}
    assert calls[1][1] == {0: [1, 2], 1: [0, 1]}  # b saw a's claims removed


def test_uninitialized_respects_topology():
    target = ShardTimeRanges({0: {0}, 1: {0}})
    src = uninitialized_source(has_peer_with_shard=lambda s: s == 1)
    out = src("ns", target)
    # shard 1 has a live peer somewhere: NOT claimed empty
    assert out.to_dict() == {0: [0]}


def test_database_bootstrap_reports_fs_and_commitlog_ranges(tmp_path):
    db = Database(str(tmp_path), num_shards=4)
    db.create_namespace("default", NamespaceOptions(block_size_nanos=2 * HOUR))
    sids = [f"s{i}".encode() for i in range(8)]
    for sid in sids:
        db.write("default", sid, T0 + NANOS, 1.0)
        db.write("default", sid, T0 + 2 * HOUR + NANOS, 2.0)  # second block
    db.flush("default", ((T0 // (2 * HOUR)) * (2 * HOUR)) + 2 * HOUR)  # flush block 1
    db.close()

    db2 = Database(str(tmp_path), num_shards=4)
    db2.create_namespace("default", NamespaceOptions(block_size_nanos=2 * HOUR))
    res = db2.bootstrap(now_nanos=T0 + 4 * HOUR)
    src = res["sources"]["default"]
    assert src["unfulfilled"] == {}
    # flushed block came from the filesystem source, the buffered second
    # block from the WAL replay; the rest of the retention window is
    # legitimately uninitialized
    assert src["fulfilled"]["filesystem"] >= 1
    assert src["fulfilled"]["commitlog_snapshot"] >= 1
    assert src["fulfilled"]["uninitialized"] > 0
    # data intact across both sources
    for sid in sids:
        vals = [dp.value for dp in db2.read("default", sid, T0, T0 + 3 * HOUR)]
        assert vals == [1.0, 2.0]
    db2.close()


# ---- faults
@pytest.fixture(autouse=True)
def _clean_seam():
    """No injected plan may leak into another test (the seam is a process
    global, exactly like the disk it stands in for)."""
    yield
    install_plan(None)


def _mkdb(path, **kwargs):
    db = Database(str(path), num_shards=2, **kwargs)
    db.create_namespace(
        "t",
        NamespaceOptions(
            retention_nanos=48 * HOUR, block_size_nanos=BSZ
        ),
    )
    db.bootstrapped = True
    return db


def test_plan_determinism_and_json_roundtrip():
    def seq(plan, n=64):
        return [plan.decide("write", "data", 100) for _ in range(n)]

    rules = [
        DiskFaultRule(op="write", path_class="data", torn=0.3, bitflip=0.2),
        DiskFaultRule(eio=0.1),
    ]
    a = seq(DiskFaultPlan(rules_copy(rules), seed=42))
    b = seq(DiskFaultPlan(rules_copy(rules), seed=42))
    assert a == b and any(action != "pass" for action, _ in a)
    # a different seed draws a different schedule
    assert seq(DiskFaultPlan(rules_copy(rules), seed=43)) != a
    # JSON roundtrip: same schedule, runtime hit counts stripped
    plan = DiskFaultPlan(rules_copy(rules), seed=42)
    plan.rules[0].hits = 7
    clone = DiskFaultPlan.from_json(plan.to_json())
    assert clone.seed == 42 and clone.rules[0].hits == 0
    assert clone.rules[0].torn == 0.3 and clone.rules[1].eio == 0.1
    assert seq(clone) == a


def test_rule_max_hits_bounds_injection():
    plan = DiskFaultPlan([DiskFaultRule(eio=1.0, max_hits=2)], seed=1)
    actions = [plan.decide("write", "data")[0] for _ in range(5)]
    assert actions == ["eio", "eio", "pass", "pass", "pass"]


def test_classify_path():
    assert classify_path("/x/data/fileset-0-1-data.db") == "data"
    assert classify_path("/x/data/fileset-0-1-checkpoint.db") == "checkpoint"
    # the durable-write temp spelling classifies as its final name
    assert classify_path("/x/.fileset-0-1-checkpoint.db.tmp") == "checkpoint"
    assert classify_path("/x/commitlogs/t/commitlog-3.wal") == "commitlog"
    assert classify_path("/x/snapshots/t/0/snapshot-1.db") == "snapshot"
    assert classify_path("/x/whatever.bin") == "other"


def test_torn_commitlog_write_replays_clean_prefix(tmp_path):
    cl = CommitLog(str(tmp_path / "wal"), write_behind=False)
    for i in range(3):
        cl.write(CommitLogEntry(b"s", T0 + i * NANOS, float(i), Unit.SECOND))
    install_plan(
        DiskFaultPlan(
            [DiskFaultRule(op="write", path_class="commitlog",
                           torn=1.0, max_hits=1)],
            seed=9,
        )
    )
    with pytest.raises(OSError):
        cl.write(CommitLogEntry(b"s", T0 + 3 * NANOS, 3.0, Unit.SECOND))
    install_plan(None)
    # the torn final record is on disk; replay stops cleanly before it
    entries = CommitLog.replay(str(tmp_path / "wal"))
    assert [e.value for e in entries] == [0.0, 1.0, 2.0]


def test_injected_bitflip_detected_by_scrub_with_invalidation(tmp_path):
    db = _mkdb(tmp_path, commitlog_enabled=False)
    for i in range(40):
        db.write("t", b"s%d" % (i % 4), T0 + i * NANOS, float(i))
    install_plan(
        DiskFaultPlan(
            [DiskFaultRule(op="write", path_class="data",
                           bitflip=1.0, max_hits=1)],
            seed=5,
        )
    )
    db.flush("t", T0 + 10 * BSZ)  # the data file lands silently corrupted
    install_plan(None)

    calls = []
    for ns in db.namespaces.values():
        for sh in ns.shards:
            orig = sh.invalidator

            class _Rec:
                def __init__(self, inner):
                    self._inner = inner

                def __getattr__(self, name):
                    fn = getattr(self._inner, name)

                    def wrap(*a, **k):
                        calls.append((name, a))
                        return fn(*a, **k)

                    return wrap

            sh.invalidator = _Rec(orig)

    before = _corruption_count()
    res = db.scrub()
    assert res["quarantined"] == 1 and res["scanned"] >= 1
    assert _corruption_count() > before
    # the quarantined block's caches/pool/index were expired
    assert any(name == "on_tick_expire" for name, _ in calls)
    # the volume moved aside; reads degrade (no error), listings exclude it
    quarantined = glob.glob(
        os.path.join(str(tmp_path), "quarantine", "**", "*-data.db"),
        recursive=True,
    )
    assert len(quarantined) == 1
    assert db.read("t", b"s0", T0, T0 + BSZ) == []
    # a second pass finds nothing left to quarantine
    assert db.scrub()["quarantined"] == 0
    db.close()


def test_on_disk_corruption_caught_at_first_read(tmp_path):
    """Verify-on-first-read: corruption planted AFTER a clean flush trips
    when the reader materializes, not per-query."""
    db = _mkdb(tmp_path, commitlog_enabled=False)
    for i in range(30):
        db.write("t", b"r%d" % (i % 3), T0 + i * NANOS, float(i))
    db.flush("t", T0 + 10 * BSZ)
    data = glob.glob(
        os.path.join(str(tmp_path), "**", "*-data.db"), recursive=True
    )
    assert data
    with open(data[0], "r+b") as f:
        f.seek(6)
        byte = f.read(1)
        f.seek(6)
        f.write(bytes([byte[0] ^ 0x10]))
    before = _corruption_count()
    # graceful: the read returns empty instead of raising, volume quarantines
    assert db.read("t", b"r0", T0, T0 + BSZ) == []
    assert _corruption_count() > before
    assert glob.glob(
        os.path.join(str(tmp_path), "quarantine", "**", "*-data.db"),
        recursive=True,
    )
    db.close()


def test_enospc_sync_mode_degrades_and_recovers(tmp_path):
    cl = CommitLog(str(tmp_path / "wal"), write_behind=False)
    cl.write(CommitLogEntry(b"s", T0, 1.0, Unit.SECOND))
    install_plan(
        DiskFaultPlan(
            [DiskFaultRule(op="write", path_class="commitlog", enospc=1.0)],
            seed=3,
        )
    )
    with pytest.raises(DiskFullError):
        cl.write(CommitLogEntry(b"s", T0 + NANOS, 2.0, Unit.SECOND))
    assert cl.disk_full
    install_plan(None)  # space freed
    cl.write(CommitLogEntry(b"s", T0 + 2 * NANOS, 3.0, Unit.SECOND))
    assert not cl.disk_full
    cl.close()
    # the shed write never acked and never landed; everything acked did
    assert [e.value for e in CommitLog.replay(str(tmp_path / "wal"))] == [1.0, 3.0]


def test_enospc_write_behind_parks_then_drains(tmp_path):
    cl = CommitLog(
        str(tmp_path / "wal"), write_behind=True, flush_every=1,
        degraded_retry_interval=0.01,
    )
    cl.write(CommitLogEntry(b"s", T0, 1.0, Unit.SECOND))
    cl.flush()
    install_plan(
        DiskFaultPlan(
            [DiskFaultRule(op="write", path_class="commitlog", enospc=1.0)],
            seed=3,
        )
    )
    cl.write(CommitLogEntry(b"s", T0 + NANOS, 2.0, Unit.SECOND))  # acked, parks
    deadline = time.monotonic() + 10
    while not cl.disk_full and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cl.disk_full
    # while parked: new writes and barriers shed typed-retryable, no crash
    with pytest.raises(DiskFullError):
        cl.write(CommitLogEntry(b"s", T0 + 2 * NANOS, 9.0, Unit.SECOND))
    with pytest.raises(DiskFullError):
        cl.flush()
    install_plan(None)  # space freed: the parked record drains on its own
    deadline = time.monotonic() + 10
    while cl.disk_full and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not cl.disk_full
    cl.write(CommitLogEntry(b"s", T0 + 3 * NANOS, 3.0, Unit.SECOND))
    cl.flush()
    cl.close()
    # every ACKED write recovered, in order; the shed one never landed
    assert [e.value for e in CommitLog.replay(str(tmp_path / "wal"))] == [
        1.0, 2.0, 3.0,
    ]


def test_enospc_flush_persist_degrades_then_retries(tmp_path):
    db = _mkdb(tmp_path, commitlog_enabled=False)
    for i in range(20):
        db.write("t", b"s%d" % (i % 2), T0 + i * NANOS, float(i))
    install_plan(
        DiskFaultPlan(
            [DiskFaultRule(op="write", path_class="data",
                           enospc=1.0, max_hits=1)],
            seed=11,
        )
    )
    with pytest.raises(DiskFullError):
        db.flush("t", T0 + 10 * BSZ)
    install_plan(None)
    # nothing half-written survived, buffers intact: the retry flushes all
    assert db.flush("t", T0 + 10 * BSZ)
    assert len(db.read("t", b"s0", T0, T0 + BSZ)) == 10
    assert db.scrub()["quarantined"] == 0
    db.close()


def test_database_write_sheds_while_wal_disk_full(tmp_path):
    db = _mkdb(tmp_path)
    db.write("t", b"s", T0, 1.0)
    install_plan(
        DiskFaultPlan(
            [DiskFaultRule(op="write", path_class="commitlog", enospc=1.0)],
            seed=2,
        )
    )
    db.write("t", b"s", T0 + NANOS, 2.0)  # acked; parks the WAL writer
    cl = db._commitlogs["t"]
    deadline = time.monotonic() + 10
    while not cl.disk_full and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cl.disk_full
    with pytest.raises(DiskFullError):
        db.write("t", b"s", T0 + 2 * NANOS, 3.0)
    with pytest.raises(DiskFullError):
        db.write_batch("t", [(b"s", T0 + 3 * NANOS, 4.0)])
    install_plan(None)
    deadline = time.monotonic() + 10
    while cl.disk_full and time.monotonic() < deadline:
        time.sleep(0.005)
    db.write("t", b"s", T0 + 4 * NANOS, 5.0)  # writes resume, no restart
    db.flush_wals()
    assert [dp.value for dp in db.read("t", b"s", T0, T0 + BSZ)] == [
        1.0, 2.0, 5.0,
    ]
    db.close()


@pytest.mark.parametrize("mode", ["every", "interval", "none"])
def test_commitlog_sync_loss_bounds(tmp_path, mode):
    """The bound pinned per mode: writes BEFORE the last durability
    barrier always survive a hard kill; writes after it survive iff the
    mode syncs them ('every' syncs per write; 'interval' is bounded by
    the flush cadence; 'none' only at rotation/explicit barriers)."""
    cl = CommitLog(str(tmp_path / "wal"), **COMMITLOG_SYNC_MODES[mode])
    for i in range(4):
        cl.write(CommitLogEntry(b"s", T0 + i * NANOS, float(i), Unit.SECOND))
    cl.flush()  # explicit durability barrier: 0..3 are now on disk
    for i in range(4, 7):
        cl.write(CommitLogEntry(b"s", T0 + i * NANOS, float(i), Unit.SECOND))
    if mode == "interval":
        # give the write-behind writer a chance to dequeue (NOT to fsync:
        # the flush interval is 1s and we kill well before it)
        time.sleep(0.05)
    cl._crash()  # SIGKILL stand-in: queue + python file buffer die
    got = [e.value for e in CommitLog.replay(str(tmp_path / "wal"))]
    assert got[:4] == [0.0, 1.0, 2.0, 3.0]  # pre-barrier: never lost
    if mode == "every":
        assert got == [float(i) for i in range(7)]  # zero acked loss
    elif mode == "none":
        assert got == [0.0, 1.0, 2.0, 3.0]  # post-barrier all lost
    else:
        assert 4 <= len(got) <= 7  # bounded by the flush interval


def test_crash_point_arming(monkeypatch):
    calls = []
    monkeypatch.setattr(faults, "_exit", lambda code: calls.append(code))
    monkeypatch.delenv(CRASH_POINT_ENV, raising=False)
    faults.crash_point("fileset:pre-checkpoint")
    assert calls == []  # unarmed: free
    monkeypatch.setenv(
        CRASH_POINT_ENV, "fileset:pre-checkpoint, commitlog:mid-rotation"
    )
    faults.crash_point("snapshot:pre-cleanup")
    assert calls == []  # armed, but a different site
    faults.crash_point("fileset:pre-checkpoint")
    faults.crash_point("commitlog:mid-rotation")
    assert calls == [faults.CRASH_EXIT_CODE] * 2


def test_crash_at_pre_checkpoint_leaves_incomplete_volume(tmp_path, monkeypatch):
    """Killed between digest and checkpoint, the volume is torn exactly as
    the protocol promises: data+digest durable, checkpoint absent — so the
    volume is invisible to listings and a fresh bootstrap."""
    from m3_tpu_torch.storage.fs import list_filesets

    def _boom(code):
        raise _FakeCrash(code)

    monkeypatch.setattr(faults, "_exit", _boom)
    monkeypatch.setenv(CRASH_POINT_ENV, "fileset:pre-checkpoint")
    db = _mkdb(tmp_path, commitlog_enabled=False)
    for i in range(10):
        db.write("t", b"s", T0 + i * NANOS, float(i))
    with pytest.raises(_FakeCrash):
        db.flush("t", T0 + 10 * BSZ)
    monkeypatch.delenv(CRASH_POINT_ENV)
    files = glob.glob(os.path.join(str(tmp_path), "**", "fileset-*.db"),
                      recursive=True)
    roles = {os.path.basename(p).rsplit("-", 1)[1] for p in files}
    assert "data.db" in roles and "digest.db" in roles
    assert "checkpoint.db" not in roles
    fids = list_filesets(str(tmp_path), "t", 0) + list_filesets(
        str(tmp_path), "t", 1
    )
    assert fids == []  # incomplete volume: invisible to listings
    db.close()
    # a fresh bootstrap on the torn dir comes up clean (no half volume)
    db2 = Database(str(tmp_path), num_shards=2)
    db2.create_namespace(
        "t", NamespaceOptions(retention_nanos=48 * HOUR, block_size_nanos=BSZ)
    )
    db2.bootstrap()
    assert db2.read("t", b"s", T0, T0 + BSZ) == []
    db2.close()


def test_quarantine_retention_prunes_old_volumes(tmp_path):
    from m3_tpu_torch.storage import fs as fsm

    db, files = _quarantine_one_volume(tmp_path)
    gauge_before = _gauge_value()
    pruned_before = _pruned_count()

    # young volume + positive retention: kept (post-mortem window)
    assert fsm.prune_quarantine(db.base, 3600.0) == 0
    assert all(os.path.exists(p) for p in files)
    # retention disabled: kept forever regardless of age
    assert fsm.prune_quarantine(db.base, 0.0) == 0

    # injected `now` ages the volume past retention: the WHOLE volume
    # prunes atomically, the counter bumps, the gauge drops
    assert fsm.prune_quarantine(db.base, 3600.0, now=time.time() + 7200) == 1
    assert not any(os.path.exists(p) for p in files)
    assert _pruned_count() == pruned_before + 1
    assert _gauge_value() == gauge_before - 1
    # idempotent: nothing left to prune
    assert fsm.prune_quarantine(db.base, 3600.0, now=time.time() + 7200) == 0
    db.close()


def _corruption_count():
    from m3_tpu_torch.utils.instrument import DEFAULT as METRICS

    fam = METRICS.collect().get("m3tpu_storage_corruption_total")
    return sum(c["value"] for c in fam["children"]) if fam else 0.0



def rules_copy(rules):
    return [DiskFaultRule(**{**r.__dict__, "hits": 0}) for r in rules]


class _FakeCrash(BaseException):
    """Stands in for os._exit: nothing may catch it on the way out."""


def _gauge_value():
    from m3_tpu_torch.utils.instrument import DEFAULT as METRICS

    fam = METRICS.collect().get("m3tpu_storage_quarantined_volumes")
    return sum(c["value"] for c in fam["children"]) if fam else 0.0


def _pruned_count():
    from m3_tpu_torch.utils.instrument import DEFAULT as METRICS

    fam = METRICS.collect().get("m3tpu_storage_quarantine_pruned_total")
    return sum(c["value"] for c in fam["children"]) if fam else 0.0


def _quarantine_one_volume(tmp_path):
    """Flush one fileset with a silently corrupted data file, scrub it
    into quarantine, and return (db, quarantined file paths)."""
    db = _mkdb(tmp_path, commitlog_enabled=False)
    for i in range(40):
        db.write("t", b"s%d" % (i % 4), T0 + i * NANOS, float(i))
    install_plan(
        DiskFaultPlan(
            [DiskFaultRule(op="write", path_class="data",
                           bitflip=1.0, max_hits=1)],
            seed=5,
        )
    )
    db.flush("t", T0 + 10 * BSZ)
    install_plan(None)
    assert db.scrub()["quarantined"] == 1
    files = glob.glob(
        os.path.join(str(tmp_path), "quarantine", "**", "*.db"),
        recursive=True,
    )
    assert files  # the whole volume moved aside
    return db, files



# ---- the port's own cases


def test_fileset_device_decode(tmp_path):
    """Side tables in the fileset let the port's records decode run
    without a prescan: its lanes come straight from the side file."""
    base = str(tmp_path)
    fid = FilesetID("ns", 0, T0)
    rng = np.random.default_rng(4)
    series = {}
    for i in range(7):
        n = int(rng.integers(3, 90))
        ts = [T0 + int(t) * NANOS for t in np.cumsum(rng.integers(1, 9, n))]
        series[f"s{i}".encode()] = jencode_series(ts, np.round(rng.normal(0, 9, n), 2).tolist())
    write_fileset(base, fid, series, 2 * HOUR)

    r = FilesetReader(base, fid)
    sids = r.series_ids
    batch = r.chunked_batch(sids)
    p = fused.pack_lanes(batch, order="s", device="cpu")
    res = chunked.decode_chunked(p.windows, p.lanes, len(sids), batch.num_chunks, batch.k)
    ts, vals, valid = (x.numpy() for x in finalize_decode(res))
    for i, sid in enumerate(sids):
        want = decode(series[sid])
        assert ts[i][valid[i]].tolist() == [dp.timestamp for dp in want]
        assert vals[i][valid[i]].tolist() == [dp.value for dp in want]


def test_commitlog_rotation_and_cleanup_is_deterministic(tmp_path):
    """The rotation/cleanup case 200 times in a row: write-behind cleanup is
    a barrier on the writer thread, so the replay after it always sees the
    write enqueued before it."""
    for rep in range(200):
        wal_dir = str(tmp_path / f"wal{rep}")
        cl = CommitLog(wal_dir, flush_every=1)
        cl.write(CommitLogEntry(b"a", T0, 1.0))
        cl.rotate()
        cl.write(CommitLogEntry(b"a", T0 + 10 * NANOS, 2.0))
        cl.rotate()
        cl.write(CommitLogEntry(b"a", T0 + 20 * NANOS, 3.0))
        assert len(cl.inactive_segments()) == 2
        assert cl.cleanup(lambda e: e.time_nanos < T0 + 5 * NANOS) == 1
        assert [e.value for e in CommitLog.replay(wal_dir)] == [2.0, 3.0]
        cl.close()


def test_shard_for_agrees_with_reference():
    rng = np.random.default_rng(11)
    ids = [rng.bytes(int(n)) for n in rng.integers(0, 40, 10_000)]
    for shards in (1, 4, 8, 4096):
        assert [thash.shard_for(i, shards) for i in ids] == [jhash.shard_for(i, shards) for i in ids]
    np.testing.assert_array_equal(thash.murmur3_32_batch(ids[:500], seed=7),
                                  jhash.murmur3_32_batch(ids[:500], seed=7))


def _series_block(n=24, seed=3):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        k = int(rng.integers(1, 200))
        ts = T0 + NANOS * np.cumsum(rng.integers(1, 30, k))
        vals = np.round(rng.normal(50, 9, k), 2) if i % 3 else rng.integers(0, 1000, k).astype(float)
        out[f"series-{i}".encode()] = jencode_series([int(t) for t in ts], vals.tolist())
    return out


def _fileset_files(base, fid):
    d = os.path.join(base, "data", fid.namespace, str(fid.shard))
    return sorted(f for f in os.listdir(d) if f.startswith(f"fileset-{fid.block_start}-{fid.volume}-"))


def test_filesets_byte_identical_and_read_across(tmp_path):
    series = _series_block()
    fid_j = jfs.FilesetID("ns", 3, T0, 0)
    fid_t = FilesetID("ns", 3, T0, 0)
    jfs.write_fileset(str(tmp_path / "j"), fid_j, series, BSZ)
    write_fileset(str(tmp_path / "t"), fid_t, series, BSZ)
    names = _fileset_files(str(tmp_path / "j"), fid_j)
    assert names == _fileset_files(str(tmp_path / "t"), fid_t) and len(names) == 8
    for name in names:
        assert filecmp.cmp(tmp_path / "j" / "data" / "ns" / "3" / name,
                           tmp_path / "t" / "data" / "ns" / "3" / name, shallow=False), name
    # each package reads the other's files
    tr = FilesetReader(str(tmp_path / "j"), fid_t)
    jr = jfs.FilesetReader(str(tmp_path / "t"), fid_j)
    assert sorted(tr.series_ids) == sorted(jr.series_ids) == sorted(series)
    for sid, stream in series.items():
        assert tr.stream(sid) == jr.stream(sid) == stream
        assert tr.side_table(sid) == jr.side_table(sid)
    assert jfs.verify_fileset(str(tmp_path / "t"), fid_j) == []


def test_commitlog_segments_byte_identical_and_replay_across(tmp_path):
    entries = [(f"s{i % 7}".encode(), T0 + i * NANOS, float(i) * 0.5, i % 3) for i in range(300)]
    for pkg, d in ((jcommitlog, "j"), (None, "t")):
        cls, ent = (pkg.CommitLog, pkg.CommitLogEntry) if pkg else (CommitLog, CommitLogEntry)
        unit = jcommitlog.Unit if pkg else Unit
        cl = cls(str(tmp_path / d), flush_every=1, write_behind=False)
        for sid, t, v, u in entries:
            cl.write(ent(sid, t, v, unit(u + 1), b"ann" if u == 2 else b""))
        cl.rotate()
        cl.write_batch([ent(b"tail", T0, 9.0)])
        cl.close()
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 2
    for name in names:
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name, shallow=False)
    got_t = CommitLog.replay(str(tmp_path / "j"))
    got_j = jcommitlog.CommitLog.replay(str(tmp_path / "t"))
    assert [(e.series_id, e.time_nanos, e.value, int(e.unit), e.annotation) for e in got_t] == \
        [(e.series_id, e.time_nanos, e.value, int(e.unit), e.annotation) for e in got_j]
    assert len(got_t) == 301


def test_snapshots_byte_identical_and_read_across(tmp_path):
    series = _series_block(8)
    records = [(sid, T0 + (i % 2) * BSZ, stream, i % 3 - 1) for i, (sid, stream) in enumerate(series.items())]
    jsnapshot.write_snapshot(str(tmp_path / "j"), "ns", 1, records)
    tsnapshot.write_snapshot(str(tmp_path / "t"), "ns", 1, records)
    rel = os.path.join("snapshots", "ns", "1", "snapshot-0.db")
    assert filecmp.cmp(tmp_path / "j" / rel, tmp_path / "t" / rel, shallow=False)
    assert tsnapshot.read_latest_snapshot(str(tmp_path / "j"), "ns", 1) == records
    assert jsnapshot.read_latest_snapshot(str(tmp_path / "t"), "ns", 1) == records


def _write_both(tmp_path, num_shards=4):
    """The same writes through both packages' Databases: two blocks of
    tagged series, the first flushed, plus one cold write and a snapshot."""
    from m3_tpu.block.core import make_tags as jmake_tags

    dbs = {
        "j": JDatabase(str(tmp_path / "j"), num_shards=num_shards, commitlog_sync="every"),
        "t": Database(str(tmp_path / "t"), num_shards=num_shards, commitlog_sync="every"),
    }
    rng = np.random.default_rng(8)
    batch = []
    for i in range(40):
        tags = jmake_tags({b"__name__": b"cpu", b"host": f"h{i}".encode(), b"job": f"j{i % 3}".encode()})
        for k in range(int(rng.integers(5, 60))):
            batch.append((tags, T0 + k * 73 * NANOS + i, float(np.round(rng.normal(10, 3), 3)), 1))
        batch.append((tags, T0 + BSZ + i * NANOS, float(i), 1))
    for name, db in dbs.items():
        db.create_namespace("m", JNamespaceOptions() if name == "j" else NamespaceOptions())
        assert db.write_tagged_batch("m", batch) == [None] * len(batch)
        db.flush("m", T0 + BSZ)
        db.write("m", b"cold", T0 + 5, 1.5)
        db.flush("m", T0 + BSZ)
        db.write("m", b"cold", T0 + 6, 2.5)
        db.snapshot("m")
    return dbs


def _tree(base):
    out = {}
    for root, _dirs, files in os.walk(base):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = fh.read()
    return out


def test_database_files_byte_identical_and_restart_across(tmp_path):
    """The same writes, flushes, cold flush and snapshot through both
    Databases leave byte-identical filesets, snapshots and index segments
    (commit-log segments too); each package bootstraps from the other's
    directory and reads every series back equal."""
    dbs = _write_both(tmp_path)
    for db in dbs.values():
        db.close()
    tj, tt = _tree(str(tmp_path / "j")), _tree(str(tmp_path / "t"))
    assert sorted(tj) == sorted(tt)
    assert any(k.startswith("data") for k in tj) and any(k.startswith("snapshots") for k in tj)
    for k in tj:
        assert tj[k] == tt[k], k
    # bootstrap each package over the other's directory
    j2 = JDatabase(str(tmp_path / "t"), num_shards=4)
    t2 = Database(str(tmp_path / "j"), num_shards=4)
    j2.create_namespace("m", JNamespaceOptions())
    t2.create_namespace("m", NamespaceOptions())
    rj = j2.bootstrap(now_nanos=T0 + 2 * BSZ)
    rt = t2.bootstrap(now_nanos=T0 + 2 * BSZ)
    assert rj == rt
    sids = sorted({sid for sh in t2.namespaces["m"].shards for sid in sh.series}
                  | {sid for sh in t2.namespaces["m"].shards
                     for f in sh.filesets() for sid in sh.reader(f).series_ids})
    assert len(sids) == 41
    for sid in sids:
        a = j2.read_arrays("m", sid, T0, T0 + 2 * BSZ)
        b = t2.read_arrays("m", sid, T0, T0 + 2 * BSZ)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    j2.close()
    t2.close()
