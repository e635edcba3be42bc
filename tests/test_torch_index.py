"""Port parity for the inverted index's host tier (m3_tpu_torch.index):
segments, the query executor, the postings cache, mmap'd disk segments and
the namespace index, each held against its ``m3_tpu`` counterpart on the
same numpy-seeded docs with exact equality of doc ids. The segment formats
carry state across the packages: ``SealedSegment.serialize`` bytes, disk
segment files and ``NamespaceIndex.persist_before`` directories written by
either package are read by the other and answer every query the same.
"""

import os
import random

import numpy as np
import pytest

import m3_tpu.index.query as jq
import m3_tpu_torch.index.query as tq
from m3_tpu.index import disk_segment as jdisk
from m3_tpu.index import segment as jseg
from m3_tpu.index.ns_index import NamespaceIndex as JNamespaceIndex
from m3_tpu.utils import blob as jblob
from m3_tpu.utils import serialize as jser
from m3_tpu_torch.index import disk_segment as tdisk
from m3_tpu_torch.index import segment as tseg
from m3_tpu_torch.index.ns_index import NamespaceIndex
from m3_tpu_torch.index.postings_cache import PostingsListCache
from m3_tpu_torch.utils import blob as tblob
from m3_tpu_torch.utils import serialize as tser

NANOS = 1_000_000_000
HOUR = 3600 * NANOS
T0 = 1_600_000_000 * NANOS
SPAN = (T0 - HOUR, T0 + 6 * HOUR)


def corpus(n, seed=0, multi=False):
    """(id, tags) docs with numpy-seeded tag values: shared and unique
    values, a field half the docs lack, an empty value, a NUL byte, and a
    newline; ``multi`` gives some docs two values of one field."""
    rng = np.random.default_rng(seed)
    roles = [b"db", b"db-replica", b"web", b"w\x00eird", b"", b"ab", b"abc", b"x\ny"]
    out = []
    for i in range(n):
        tags = [(b"name", b"metric_%d" % (i % max(n // 40, 7))),
                (b"host", b"h%04d" % rng.integers(max(n // 5, 10))),
                (b"dc", b"dc%d" % (i % 3))]
        if rng.random() < 0.5:
            tags.append((b"role", roles[rng.integers(len(roles))]))
        if multi and i % 7 == 0:
            tags.append((b"dc", b"dc-extra"))
        out.append((b"s%d" % i, tuple(sorted(tags))))
    return out


# query specs, built in either package by build_query
QUERIES = [
    ("term", b"name", b"metric_3"),
    ("term", b"name", b"nope"),
    ("term", b"missing_field", b"x"),
    ("term", b"role", b""),
    ("term", b"role", b"w\x00eird"),
    ("re", b"name", b"metric_1[0-9]"),
    ("re", b"name", b"metric_1.*"),
    ("re", b"name", b"metric_1|metric_2"),
    ("re", b"host", b"h00.*"),
    ("re", b"role", b"db.*"),
    ("re", b"role", b".*"),
    ("re", b"name", b"met+ric_4"),
    ("field", b"role"),
    ("field", b"absent"),
    ("all",),
    ("neg", ("all",)),
    ("conj", ("term", b"dc", b"dc1"), ("re", b"name", b"metric_.*")),
    ("conj", ("term", b"dc", b"dc0"), ("neg", ("term", b"host", b"h0001"))),
    ("conj", ("neg", ("term", b"dc", b"dc2"))),
    ("disj", ("term", b"dc", b"dc0"), ("term", b"dc", b"dc2"), ("term", b"name", b"metric_1")),
    ("disj", ("neg", ("field", b"role")), ("re", b"host", b"h000.*")),
    ("conj", ("disj", ("term", b"dc", b"dc0"), ("term", b"dc", b"dc1")),
     ("neg", ("re", b"name", b"metric_[0-3]")), ("field", b"host")),
]


def build_query(mod, spec):
    kind = spec[0]
    if kind == "term":
        return mod.term(spec[1], spec[2])
    if kind == "re":
        return mod.regexp(spec[1], spec[2])
    if kind == "field":
        return mod.FieldQuery(spec[1])
    if kind == "all":
        return mod.AllQuery()
    if kind == "neg":
        return mod.neg(build_query(mod, spec[1]))
    subs = [build_query(mod, s) for s in spec[1:]]
    return mod.conj(*subs) if kind == "conj" else mod.disj(*subs)


def both_segments(docs):
    """The same docs in a port and an m3_tpu MutableSegment."""
    t, j = tseg.MutableSegment(), jseg.MutableSegment()
    for did, tags in docs:
        t.insert(tseg.Document(did, tags))
        j.insert(jseg.Document(did, tags))
    return t, j


def assert_same_search(tseg_, jseg_, cache=None):
    for spec in QUERIES:
        got = tq.search_segment(tseg_, build_query(tq, spec), cache)
        want = jq.search_segment(jseg_, build_query(jq, spec))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=repr(spec))


# ---------- tags codec and blob files ----------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tag_codec_matches(seed):
    rng = random.Random(seed)
    for _ in range(50):
        tags = [(bytes(rng.randrange(256) for _ in range(rng.randrange(1, 8))),
                 bytes(rng.randrange(256) for _ in range(rng.randrange(0, 12))))
                for _ in range(rng.randrange(0, 6))]
        enc = tser.encode_tags(tags)
        assert enc == jser.encode_tags(tags)
        assert tser.decode_tags(enc) == jser.decode_tags(enc)
        assert tser.is_tag_id(enc)
    for bad in (b"", b"\x35\x4d\x01\x00", b"xx\x00\x00"):
        with pytest.raises(ValueError):
            tser.decode_tags(bad)


def test_blob_files_cross(tmp_path):
    body = bytes(range(256)) * 3
    a, b = str(tmp_path / "d" / "a.blob"), str(tmp_path / "b.blob")
    tblob.write_atomic_checked_blob(a, 0x1234, body)
    jblob.write_atomic_checked_blob(b, 0x1234, body)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert jblob.read_checked_blob(a, 0x1234) == body
    assert tblob.read_checked_blob(b, 0x1234) == body
    assert tblob.read_checked_blob(a, 0x9999) is None
    with open(a, "r+b") as f:  # a torn / corrupt file reads as absent
        f.seek(10)
        f.write(b"\xff")
    assert tblob.read_checked_blob(a, 0x1234) is None
    assert tblob.read_checked_blob(str(tmp_path / "missing"), 0x1234) is None
    assert not [n for n in os.listdir(tmp_path / "d") if n.endswith(".tmp")]


# ---------- segments and the executor ----------


@pytest.mark.parametrize("pattern", [
    b"metric_1.*", b"^metric_1", b"a|b", b"(ab)c", b"ab*", b"ab+c", b"x\\.y", b"", b"[ab]c",
    b"abc?", b"a{2}", b"\xff\xff", b"ab\xff",
])
def test_literal_prefix_and_upper(pattern):
    assert tseg.literal_prefix(pattern) == jseg.literal_prefix(pattern)
    assert tseg.prefix_upper(pattern) == jseg.prefix_upper(pattern)
    assert tseg.REGEXP_SPECIALS == jseg.REGEXP_SPECIALS


@pytest.mark.parametrize("sealed", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_search_queries(sealed, seed):
    t, j = both_segments(corpus(900, seed))
    if sealed:
        t, j = t.seal(), j.seal()
    assert_same_search(t, j)
    assert t.fields() == j.fields()
    for f in j.fields():
        assert list(t.terms(f)) == list(j.terms(f))


def test_insert_dedupe_and_executor_across_segments():
    docs = corpus(300, 3)
    t1, j1 = both_segments(docs)
    assert t1.insert(tseg.Document(docs[0][0], ((b"name", b"x"),))) == 0
    t2, j2 = both_segments(corpus(200, 4) + [(b"new", ((b"name", b"metric_1"),))])
    for spec in QUERIES:
        for limit in (None, 5, 250):
            got = tq.execute([t1.seal(), t2], build_query(tq, spec), limit=limit)
            want = jq.execute([j1.seal(), j2], build_query(jq, spec), limit=limit)
            assert got.ids() == want.ids(), spec
            assert len(got) == len(want)
            assert [d.id for d in got] == [d.id for d in want]
            if len(want):
                assert (got[-1].id, got[-1].fields) == (want[-1].id, want[-1].fields)


@pytest.mark.parametrize("multi", [False, True])
def test_sealed_serialize_bytes_cross(multi):
    """Serialized segments are byte-identical, and bytes from either
    package deserialize in the other and answer every query the same."""
    t, j = both_segments(corpus(700, 5, multi=multi))
    tb, jb = t.seal().serialize(), j.seal().serialize()
    assert tb == jb
    back_t = tseg.SealedSegment.deserialize(jb)
    back_j = jseg.SealedSegment.deserialize(tb)
    assert [d.id for d in back_t.docs] == [d.id for d in back_j.docs]
    assert [d.fields for d in back_t.docs] == [d.fields for d in back_j.docs]
    assert_same_search(back_t, back_j)


def test_merge_segments_dedupes_by_id():
    a, ja = both_segments(corpus(50, 6))
    b, jb = both_segments(corpus(80, 7))  # overlaps a's ids
    merged = tseg.merge_segments([a.seal(), b.seal()])
    jmerged = jseg.merge_segments([ja.seal(), jb.seal()])
    assert len(merged) == len(jmerged) == 80
    assert merged.serialize() == jmerged.serialize()


# ---------- disk segments ----------


@pytest.mark.parametrize("multi", [False, True])
def test_disk_segment_files_cross(tmp_path, multi):
    """A file written by either package is byte-identical, opens as the
    other's DiskSegment and answers every query as the sealed segment
    does (v2 columnar, and v1 when a doc has two values of one field)."""
    t, j = both_segments(corpus(800, 8, multi=multi))
    ts, js = t.seal(), j.seal()
    tp = tdisk.write_disk_segment(str(tmp_path / "t.idx"), ts)
    jp = jdisk.write_disk_segment(str(tmp_path / "j.idx"), js)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    port_reads_jax, jax_reads_port = tdisk.DiskSegment(jp), jdisk.DiskSegment(tp)
    assert port_reads_jax.version == jax_reads_port.version == (1 if multi else 2)
    assert_same_search(port_reads_jax, js)
    assert_same_search(port_reads_jax, jax_reads_port)
    for i in (0, 1, 399, 799):
        a, b = port_reads_jax.doc(i), jax_reads_port.doc(i)
        assert (a.id, a.fields) == (b.id, b.fields)
    assert port_reads_jax.doc_ids(np.arange(10)) == [d.id for d in js.docs[:10]]
    assert port_reads_jax.postings(b"ghost", b"x").size == 0
    port_reads_jax.close()


# ---------- the postings cache ----------


def test_postings_cache_hits_on_repeated_regexp(tmp_path):
    ix = NamespaceIndex(block_size_nanos=HOUR)
    for i in range(200):
        ix.write(b"s%d" % i, ((b"host", b"h%d" % (i % 5)),), T0)
    ix.persist_before(str(tmp_path), "ns", T0 + 2 * HOUR)  # immutable now
    q = tq.regexp(b"host", b"h[0-3]")
    r1 = ix.query(q, T0 - HOUR, T0 + HOUR)
    misses = ix.postings_cache.misses
    r2 = ix.query(q, T0 - HOUR, T0 + HOUR)
    assert r1.docs.ids() == r2.docs.ids() and len(r1.docs) == 160
    assert ix.postings_cache.hits >= 1
    assert ix.postings_cache.misses == misses  # second run fully cached


def test_mutable_segments_bypass_cache():
    cache = PostingsListCache()
    m, _ = both_segments(corpus(50, 9))
    out1 = tq.search_segment(m, tq.regexp(b"dc", b"dc1"), cache)
    m.insert(tseg.Document(b"new", ((b"dc", b"dc1"),)))
    out2 = tq.search_segment(m, tq.regexp(b"dc", b"dc1"), cache)
    assert len(out2) == len(out1) + 1  # fresh result, not a stale cache hit
    assert len(cache) == 0


def test_cache_lru_eviction_and_invalidation():
    cache = PostingsListCache(capacity=2)
    cache.put(("a",), np.zeros(1, np.int32))
    cache.put(("b",), np.zeros(2, np.int32))
    cache.get(("a",))
    cache.put(("c",), np.zeros(3, np.int32))  # evicts b (LRU)
    assert cache.get(("b",)) is None
    assert cache.get(("a",)) is not None
    assert cache.get(("c",)) is not None
    seg = both_segments(corpus(40, 10))[0].seal()
    tq.search_segment(seg, tq.FieldQuery(b"host"), cache)
    assert cache.invalidate_segment(seg) == 1
    assert cache.stats()["invalidations"] == 1


# ---------- the namespace index ----------


def both_indexes(block=HOUR):
    return NamespaceIndex(block), JNamespaceIndex(block)


def write_both(pair, docs, t):
    for ix in pair:
        ix.write_batch([(did, tags, t) for did, tags in docs])


def assert_same_queries(tix, jix, span=SPAN):
    for spec in QUERIES:
        for limit in (None, 7):
            got = tix.query(build_query(tq, spec), *span, limit=limit)
            want = jix.query(build_query(jq, spec), *span, limit=limit)
            assert got.docs.ids() == want.docs.ids(), spec
            assert got.exhaustive == want.exhaustive


def test_ns_index_blocks_and_aggregate():
    pair = both_indexes(2 * HOUR)
    write_both(pair, corpus(400, 11), T0)
    write_both(pair, corpus(300, 12), T0 + 3 * HOUR)
    tix, jix = pair
    assert_same_queries(tix, jix)
    assert_same_queries(tix, jix, (T0, T0 + HOUR))
    for q in (None, ("term", b"dc", b"dc1")):
        for ff in (None, [b"name"]):
            got = tix.aggregate_query(q and build_query(tq, q), *SPAN, field_filter=ff)
            want = jix.aggregate_query(q and build_query(jq, q), *SPAN, field_filter=ff)
            assert got == want
    for ix in pair:
        ix.seal_before(T0 + 2 * HOUR)
    assert_same_queries(tix, jix)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ns_index_persist_files_cross(tmp_path, writer):
    """persist_before files of either package load in the other's
    load_persisted; both then answer every query as the writer does."""
    pair = both_indexes()
    write_both(pair, corpus(600, 13), T0)
    write_both(pair, corpus(300, 14), T0 + HOUR)
    tix, jix = pair
    src = tix if writer == "port" else jix
    base = str(tmp_path)
    paths = src.persist_before(base, "ns", T0 + 3 * HOUR)
    assert len(paths) == 2 and all(p.endswith(".idx") for p in paths)
    t2, j2 = both_indexes()
    assert t2.load_persisted(base, "ns") == j2.load_persisted(base, "ns") == {
        T0 // HOUR * HOUR, T0 // HOUR * HOUR + HOUR}
    assert_same_queries(t2, j2)
    assert_same_queries(t2, jix)
    assert t2.aggregate_query(None, *SPAN) == jix.aggregate_query(None, *SPAN)


def test_ns_index_persist_skips_clean_and_reads_legacy(tmp_path):
    """A clean block is not rewritten; a corrupt file reads as absent; a
    legacy blob segment file (written here in the reference's format)
    loads."""
    base = str(tmp_path)
    tix = NamespaceIndex(HOUR)
    tix.write_batch([(did, tags, T0) for did, tags in corpus(100, 15)])
    (path,) = tix.persist_before(base, "ns", T0 + 2 * HOUR)
    assert tix.persist_before(base, "ns", T0 + 2 * HOUR) == []
    d = os.path.dirname(path)
    bad = os.path.join(d, f"segments-{T0 // HOUR * HOUR + HOUR}.idx")
    with open(bad, "wb") as f:
        f.write(b"not a segment file" * 4)  # bad magic
    legacy_bs = T0 // HOUR * HOUR + 2 * HOUR
    _, j = both_segments(corpus(60, 16))
    raw = j.seal().serialize()
    body = len([raw]).to_bytes(4, "little") + len(raw).to_bytes(8, "little") + raw
    jblob.write_atomic_checked_blob(os.path.join(d, f"segments-{legacy_bs}.db"), 0x6D334958, body)
    t2, j2 = both_indexes()
    assert t2.load_persisted(base, "ns") == j2.load_persisted(base, "ns") == {
        T0 // HOUR * HOUR, legacy_bs}
    assert_same_queries(t2, j2, (T0 - HOUR, T0 + 4 * HOUR))


def test_ns_index_retention_drops_blocks_and_files(tmp_path):
    base = str(tmp_path)
    pair = both_indexes()
    write_both(pair, corpus(200, 17), T0)
    write_both(pair, corpus(200, 18), T0 + 2 * HOUR)
    tix, jix = pair
    for ix in pair:
        ix.persist_before(base + ("/t" if ix is tix else "/j"), "ns", T0 + 4 * HOUR)
        ix.evict_before(T0 + HOUR, base + ("/t" if ix is tix else "/j"), "ns")
    assert sorted(tix.blocks) == sorted(jix.blocks) == [T0 // HOUR * HOUR + 2 * HOUR]
    assert sorted(os.listdir(base + "/t/index/ns")) == sorted(os.listdir(base + "/j/index/ns"))
    assert_same_queries(tix, jix)
