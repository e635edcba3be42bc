"""Port parity for the inverted index's device tier
(m3_tpu_torch.index.device), on the CPU.

The port's device segment runs its kernels' plain PyTorch twins here (the
store lives on the CPU); ``m3_tpu``'s runs its XLA programs on the CPU.
For any query AST and any segment state (sealed and admitted, mutable,
persisted, evicted, rejected) the port's device executor returns exactly
the doc ids of ``m3_tpu``'s device executor and of the port's host
executor. The twins of K1 and K2 equal the reference's ``match_terms`` /
``bitmap_from_terms`` / ``bitmap_from_term_range`` word for word, and the
kernel source itself, built as host C++ (K1's warp search and K2's span
tiles run lane by lane), equals the twins. A query's leaves on a segment
take one K2 call, after every unsupported node has been found.

Where the port differs on purpose: a device fault raises instead of being
answered from the host (``test_device_fault_raises``).
"""

import bisect
import ctypes
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m3_tpu.index.query as jq
import m3_tpu_torch.index.query as tq
from m3_tpu.index.device import DeviceIndexStore as JStore
from m3_tpu.index.device import IndexDeviceOptions as JOptions
from m3_tpu.index.device import classify_regexp as jclassify
from m3_tpu.index.device import kernels as jk
from m3_tpu.index.ns_index import NamespaceIndex as JNamespaceIndex
from m3_tpu_torch.index.device import DeviceIndexStore, IndexDeviceOptions, classify_regexp
from m3_tpu_torch.index.device import batch
from m3_tpu_torch.index.device import kernels as tk
from m3_tpu_torch.index.ns_index import NamespaceIndex
from m3_tpu_torch.index.segment import Document, MutableSegment
from m3_tpu_torch.ops import _build
from m3_tpu_torch.resident.pool import ConfigError as PoolConfigError
from m3_tpu_torch.utils.config import ConfigError
from test_torch_index import QUERIES, build_query

NANOS = 1_000_000_000
HOUR = 3600 * NANOS
T0 = 1_600_000_000 * NANOS
SPAN = (T0 - HOUR, T0 + 4 * HOUR)


def make_store(max_bytes=64 << 20, **kw):
    return DeviceIndexStore(IndexDeviceOptions(max_bytes=max_bytes, **kw), device="cpu")


def make_index(store=None):
    return NamespaceIndex(HOUR, device_store=store)


def make_jax_index(max_bytes=64 << 20, **kw):
    return JNamespaceIndex(HOUR, device_store=JStore(JOptions(max_bytes=max_bytes, **kw)))


def corpus_batch(n, seed=0, t=T0):
    rng = np.random.default_rng(seed)
    roles = [b"db", b"db-replica", b"web", b"w\x00eird", b"", b"ab", b"abc"]
    batch_ = []
    for i in range(n):
        tags = [(b"name", b"metric_%d" % (i % max(n // 40, 7))),
                (b"host", b"h%04d" % rng.integers(max(n // 5, 10))),
                (b"dc", b"dc%d" % (i % 3))]
        if rng.random() < 0.5:
            tags.append((b"role", roles[rng.integers(len(roles))]))
        batch_.append((b"s%d" % i, tuple(tags), t))
    return batch_


def ids(result):
    return result.docs.ids()


def assert_parity(ix, spec, span=SPAN, limit=None, jix=None):
    """Port device == port host (== m3_tpu's device executor, when given)."""
    dev = ids(ix.query(build_query(tq, spec), *span, limit=limit))
    host = ids(ix.query(build_query(tq, spec), *span, limit=limit, force_host=True))
    assert dev == host, (spec, len(dev), len(host))
    if jix is not None:
        assert dev == ids(jix.query(build_query(jq, spec), *span, limit=limit)), spec
    return dev


def both(batches, seal_at, **kw):
    store = make_store(**kw)
    ix, jix = make_index(store), make_jax_index(**kw)
    for b in batches:
        ix.write_batch(b)
        jix.write_batch(b)
    ix.seal_before(seal_at)
    jix.seal_before(seal_at)
    return store, ix, jix


# ---------- host key helpers and bitmaps ----------


def test_key_ordering_matches_bytes_order():
    rng = random.Random(7)
    terms = [b"", b"a", b"ab", b"abc", b"ab\x00", b"ab\x00x", b"ab\x01", b"b"]
    for _ in range(200):
        terms.append(bytes(rng.randrange(0, 256) for _ in range(rng.randrange(1, 9))))
    terms = sorted(set(terms))
    k = tk.key_width_words(max(len(t) for t in terms))
    keys, lens = tk.build_term_keys(terms, k)
    jkeys, jlens = jk.build_term_keys(terms, k)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(lens, jlens)
    for _ in range(500):
        i, j = rng.randrange(len(terms)), rng.randrange(len(terms))
        assert tk.host_key_lt(keys[i], int(lens[i]), keys[j], int(lens[j])) == (terms[i] < terms[j])


def test_host_lower_bound_matches_bisect():
    rng = random.Random(11)
    terms = sorted({bytes(rng.randrange(97, 123) for _ in range(rng.randrange(1, 6)))
                    for _ in range(300)})
    k = tk.key_width_words(max(len(t) for t in terms))
    keys, lens = tk.build_term_keys(terms, k)
    for p in list(terms) + [b"a", b"zzzz", b"m", b"", b"mm\x00"]:
        pk, pl = tk.build_term_keys([p], k)
        got = tk.host_lower_bound(keys, lens, 0, len(terms), pk[0], int(pl[0]))
        assert got == bisect.bisect_left(terms, p), p


def test_bitmap_to_docids_roundtrip():
    rng = random.Random(3)
    for n_docs in (1, 31, 32, 33, 1000):
        docs = sorted(rng.sample(range(n_docs), k=max(n_docs // 3, 1)))
        words = np.zeros(-(-n_docs // 32), np.uint32)
        for d in docs:
            words[d // 32] |= np.uint32(1 << (d % 32))
        for form in (words, torch.from_numpy(words.view(np.int32))):
            out = tk.bitmap_to_docids(form)
            assert out.tolist() == docs and out.dtype == np.int32
        np.testing.assert_array_equal(tk.bitmap_to_docids(words), jk.bitmap_to_docids(words))


def test_all_docs_words_tail_masked():
    for n in (1, 31, 32, 33, 95, 96):
        w = tk.all_docs_words(n)
        np.testing.assert_array_equal(w, jk.all_docs_words(n))
        assert tk.bitmap_to_docids(w).tolist() == list(range(n))


@pytest.mark.parametrize("pattern", [
    b"metric_1", b"^metric_1$", b"metric_.*", b"a|b|c", b"(a|bc)", b"metric_[0-9]", b"a|b*",
    b"(a|b)c", b"", b".*", b"^host_1.*$", b"a||b", b"(a|b", b"x.y.*",
])
def test_classify_regexp(pattern):
    assert classify_regexp(pattern) == jclassify(pattern)


# ---------- K1 and K2: twins vs the reference's programs ----------


def key_matrix(seed, n_terms=300, max_len=11):
    """A sorted term dictionary of random byte strings (NUL extensions,
    shared prefixes) split into fields of random sizes, with its keys."""
    rng = np.random.default_rng(seed)
    pool = [bytes(rng.integers(0, 4, rng.integers(0, max_len + 1)).astype(np.uint8) + 97)
            for _ in range(n_terms * 2)]
    pool += [b"ab", b"ab\x00", b"ab\x00\x00", b"abc"]
    cuts = np.sort(rng.choice(np.arange(1, n_terms), 3, replace=False))
    fields, terms = [], []
    for lo, hi in zip([0, *cuts], [*cuts, n_terms]):
        chunk = sorted(set(pool[lo * 2 : hi * 2]))
        fields.append((len(terms), len(chunk)))
        terms += chunk
    k = tk.key_width_words(max(len(t) for t in terms))
    keys, lens = tk.build_term_keys(terms, k)
    return terms, fields, keys, lens, k


def query_rows(seed, terms, fields, k):
    """Rows over every field: present terms, absent ones, over-width
    values, empty ranges and ranges of one term."""
    rng = np.random.default_rng(seed + 100)
    values, lo, hi = [], [], []
    for start, count in fields:
        for _ in range(40):
            r = rng.random()
            if r < 0.5:
                v = terms[start + int(rng.integers(count))] if count else b""
            elif r < 0.8:
                v = bytes(rng.integers(97, 101, rng.integers(0, 9)).astype(np.uint8))
            else:
                v = b"a" * (4 * k + int(rng.integers(1, 5)))
            values.append(v)
            if rng.random() < 0.1:
                lo.append(start + count), hi.append(start + count)  # empty
            elif rng.random() < 0.1 and count:
                lo.append(start), hi.append(start + 1)  # one term
            else:
                lo.append(start), hi.append(start + count)
    qk, ql = tk.build_query_keys(values, k)
    return values, qk, ql, np.asarray(lo, np.int32), np.asarray(hi, np.int32)


def i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_terms_twin_matches_reference(seed):
    terms, fields, keys, lens, k = key_matrix(seed)
    values, qk, ql, lo, hi = query_rows(seed, terms, fields, k)
    got = tk.match_terms(i32(keys), i32(lens), i32(lo), i32(hi), i32(qk), i32(ql)).numpy()
    want = np.asarray(jk.match_terms(jnp.asarray(keys), jnp.asarray(lens), jnp.asarray(lo),
                                     jnp.asarray(hi), jnp.asarray(qk), jnp.asarray(ql)))
    np.testing.assert_array_equal(got, want)
    for v, g, a, b in zip(values, got, lo, hi):  # a hit is the value, inside its range
        assert g < 0 or (terms[g] == v and a <= g < b)
        assert g >= 0 or v not in terms[a:b]
    assert (got >= 0).any() and (got < 0).any()


def test_match_terms_twin_single_term_and_empty():
    keys, lens = tk.build_term_keys([b"abc"], 1)
    qk, ql = tk.build_query_keys([b"abc", b"ab", b"abd", b"abcde"], 1)
    lo = np.zeros(4, np.int32)
    hi = np.asarray([1, 1, 1, 1], np.int32)
    got = tk.match_terms(i32(keys), i32(lens), i32(lo), i32(hi), i32(qk), i32(ql))
    assert got.tolist() == [0, -1, -1, -1]
    got = tk.match_terms(i32(keys), i32(lens), i32(lo), i32(lo), i32(qk), i32(ql))
    assert got.tolist() == [-1] * 4


def postings_for(seed, n_terms, n_docs):
    """Sorted postings per term (some empty) and their flat layout."""
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(n_terms):
        m = int(rng.integers(0, min(n_docs, 90))) if rng.random() > 0.1 else 0
        lists.append(np.sort(rng.choice(n_docs, m, replace=False)).astype(np.int32))
    offs = np.cumsum([0] + [len(p) for p in lists])
    post_idx = np.stack([offs[:-1], offs[1:]], axis=1).astype(np.int32)
    data = np.concatenate(lists).astype(np.int32)
    return post_idx, data


def spans_of_rows(*rows):
    """K2's span list (int64 [m, 3]: row, start, end) of a few rows' spans."""
    out = [(r, a, b) for r, sp in enumerate(rows) for a, b in sp]
    return np.asarray(out, np.int64).reshape(-1, 3)


@pytest.mark.parametrize("n_docs", [1, 31, 32, 33, 1000, 4097])
def test_bitmap_twins_match_reference(n_docs):
    """K2's twins, and the span wrapper on the CPU over both forms at once,
    == the reference's programs."""
    n_terms = 40
    post_idx, data = postings_for(n_docs, n_terms, n_docs)
    n_words = -(-n_docs // 32)
    rng = np.random.default_rng(n_docs)
    jpi, jpd = jnp.asarray(post_idx), jnp.asarray(data)
    for _ in range(6):
        gis = rng.integers(-1, n_terms, rng.integers(0, 9)).astype(np.int32)
        want_t = np.asarray(jk.bitmap_from_terms(jpi, jpd, jnp.asarray(gis), n_words))
        got = tk.bitmap_from_terms_reference(i32(post_idx), i32(data), i32(gis), n_words)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want_t)
        lo, hi = sorted(rng.integers(0, n_terms + 1, 2).tolist())
        start = int(post_idx[lo, 0]) if hi > lo else 0
        end = int(post_idx[hi - 1, 1]) if hi > lo else 0
        want_r = np.asarray(jk.bitmap_from_term_range(jpi, jpd, jnp.int32(lo), jnp.int32(hi),
                                                      n_words))
        got = tk.bitmap_from_term_range_reference(i32(data), start, end, n_words).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want_r)
        assert not (tk.bitmap_to_docids(got) >= n_docs).any()  # tail bits stay 0
        spans = spans_of_rows(tk.term_spans(post_idx, gis), [(start, end)])
        got = tk.bitmap_from_spans(i32(data), spans, 2, n_words).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, np.stack([want_t, want_r]))


# ---------- the kernel source, built as host C++ ----------


@pytest.fixture(scope="module")
def host_index_kernels(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "index_kernels_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["index_kernels"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.m3_index_match_terms_host.argtypes = [P, P, I64, I, P, P, P, P, I64, P]
    lib.m3_index_bitmap_spans_host.argtypes = [P, I64, P, I64, I, P, I64, I64]
    return lib


def host_k1(lib, keys, lens, lo, hi, qk, ql):
    keys, lens, qk, ql = (np.ascontiguousarray(a) for a in (keys, lens, qk, ql))
    lo, hi = np.ascontiguousarray(lo, np.int32), np.ascontiguousarray(hi, np.int32)
    out = np.zeros(len(lo), np.int32)
    assert lib.m3_index_match_terms_host(
        keys.ctypes.data, lens.ctypes.data, len(keys), keys.shape[1], lo.ctypes.data,
        hi.ctypes.data, qk.ctypes.data, ql.ctypes.data, len(lo), out.ctypes.data) == 0
    return out


def host_k2(lib, data, spans, n_rows, n_words, shift=0):
    """K2's host build over ``spans`` with quads counted from ``shift``
    postings before ``data`` (the alignment a card's pointer would give)."""
    spans = np.ascontiguousarray(spans, np.int64)
    words = np.full((n_rows, n_words), -1, np.int32)  # the entry zeroes them
    live = n_rows * n_words > 0 and bool((spans[:, 2] > spans[:, 1]).any())
    assert lib.m3_index_bitmap_spans_host(
        data.ctypes.data, len(data), spans.ctypes.data, len(spans), shift, words.ctypes.data,
        n_rows, n_words) == (0 if live else -1)
    return words


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k1_source_host_build_matches_twin(host_index_kernels, seed):
    terms, fields, keys, lens, k = key_matrix(seed, n_terms=200 + 150 * seed)
    _, qk, ql, lo, hi = query_rows(seed, terms, fields, k)
    out = host_k1(host_index_kernels, keys, lens, lo, hi, qk, ql)
    want = tk.match_terms(i32(keys), i32(lens), i32(lo), i32(hi), i32(qk), i32(ql)).numpy()
    np.testing.assert_array_equal(out, want)


def sorted_terms(n, seed):
    """``n`` distinct sorted terms of 0-9 bytes over a small alphabet (NUL
    extensions among them)."""
    rng = np.random.default_rng(seed)
    terms = {b"", b"b", b"b\x00", b"b\x00\x00"}
    while len(terms) < n:
        m = n - len(terms)
        lens_ = rng.integers(1, 10, m)
        raw = rng.integers(0, 4, (m, 9)).astype(np.uint8) + 96
        terms |= {bytes(r[:l]) for r, l in zip(raw, lens_)}
    return sorted(terms)[:n]


@pytest.mark.parametrize("n_keys", [1, 2, 32, 33, 34, 1089, 1090, 110_000])
def test_k1_warp_search_host_build_key_counts(host_index_kernels, n_keys):
    """The 33-way warp search (host build, lane by lane) == the twin and
    bisect over whole and partial ranges of every length class: ranges of
    at most 32 keys, just above (33, 34), 33**2 and one more, ~110,000; a
    query below every key, above every key, between keys, lo == hi,
    q_len < 0, and keys padded with zero words to a wider k_max."""
    terms = sorted_terms(n_keys, n_keys)
    k = tk.key_width_words(max(len(t) for t in terms))
    rng = np.random.default_rng(n_keys + 7)
    sample = terms if n_keys <= 2000 else [terms[i] for i in rng.integers(0, n_keys, 1500)]
    values = list(sample) + [t + b"a" for t in sample[:300]] + [b"", b"\x00", b"\xff" * 5]
    lo, hi = [], []
    for i in range(len(values)):
        a = int(rng.integers(0, n_keys + 1)) if i % 3 == 0 else 0
        b = int(rng.integers(a, n_keys + 1)) if i % 3 == 1 else n_keys
        lo.append(a), hi.append(b)
    values += [terms[0], terms[-1]]  # lo == hi, at both ends
    lo += [0, n_keys]
    hi += [0, n_keys]
    values.append(b"x" * (4 * k + 4))  # wider than the keys: q_len -1
    lo.append(0), hi.append(n_keys)
    for pad in (0, 2):
        keys, lens = tk.build_term_keys(terms, k + pad)
        qk, ql = tk.build_query_keys(values, k + pad)
        if pad:
            ql[-1] = -1  # the over-width row stays unmatchable at the padded width
        out = host_k1(host_index_kernels, keys, lens, lo, hi, qk, ql)
        want = tk.match_terms_reference(i32(keys), i32(lens), i32(np.asarray(lo, np.int32)),
                                        i32(np.asarray(hi, np.int32)), i32(qk), i32(ql)).numpy()
        np.testing.assert_array_equal(out, want)
        for v, g, a, b, q in zip(values, out, lo, hi, ql):
            at = bisect.bisect_left(terms, v, a, b) if a < b else a
            hit = q >= 0 and at < b and terms[at] == v
            assert g == (at if hit else -1), (v, a, b)
    assert (out >= 0).sum() > 0 and out[-1] == -1


@pytest.mark.parametrize("n_docs", [1, 33, 1000, 4097])
def test_k2_source_host_build_matches_twin(host_index_kernels, n_docs):
    """K2's span list, host build: term-list rows (-1 gis, duplicates) and
    range rows (empty ranges) in one call == each form's twin, at every
    alignment of post_data."""
    n_terms = 50
    post_idx, data = postings_for(n_docs + 7, n_terms, n_docs)
    n_words = -(-n_docs // 32)
    rng = np.random.default_rng(n_docs + 1)
    for trial in range(8):
        gis = rng.integers(-1, n_terms, rng.integers(0, 12)).astype(np.int32)
        lo, hi = sorted(rng.integers(0, n_terms + 1, 2).tolist())
        start = int(post_idx[lo, 0]) if hi > lo else 0
        end = int(post_idx[hi - 1, 1]) if hi > lo else 0
        spans = spans_of_rows(tk.term_spans(post_idx, gis), [(start, end)],
                              tk.term_spans(post_idx, np.concatenate([gis, gis[::-1]])))
        words = host_k2(host_index_kernels, data, spans, 3, n_words, shift=trial % 4)
        want_t = tk.bitmap_from_terms_reference(i32(post_idx), i32(data), i32(gis), n_words)
        want_r = tk.bitmap_from_term_range_reference(i32(data), start, end, n_words)
        np.testing.assert_array_equal(words[0], want_t.numpy())
        np.testing.assert_array_equal(words[1], want_r.numpy())
        np.testing.assert_array_equal(words[2], want_t.numpy())


@pytest.mark.parametrize("n_docs", [31, 100, 4097, 70_001])
def test_k2_span_host_build_edge_spans(host_index_kernels, n_docs):
    """Dense runs of postings (one word across many lanes and tiles),
    overlapping and duplicate spans in one row, empty spans, spans of one
    posting, starts at every offset from a 16-byte boundary, and spans of
    different rows inside one warp's tile: == the span twin, row by row."""
    rng = np.random.default_rng(n_docs)
    dense = np.arange(n_docs, dtype=np.int32)
    sparse = np.sort(rng.choice(n_docs, min(n_docs, 300), replace=False)).astype(np.int32)
    data = np.concatenate([dense, sparse, dense[::7]])
    n_words = -(-n_docs // 32)
    n = len(data)
    rows = [
        [(0, n_docs)],
        [(3, 40), (10, 77), (3, 40), (5, 5), (n_docs, n_docs + len(sparse))],
        [(i, i + 1) for i in range(0, min(n, 200), 3)],
        [(a, a + int(rng.integers(0, 50))) for a in rng.integers(0, n - 50, 20)],
        [],
        [(n - 1, n), (0, 0), (1, 2), (2, 7)],
    ]
    spans = spans_of_rows(*rows)
    spans[:, 2] = np.minimum(spans[:, 2], n)
    for shift in range(4):
        words = host_k2(host_index_kernels, data, spans, len(rows), n_words, shift)
        want = tk.bitmap_from_spans_reference(i32(data), spans, len(rows), n_words).numpy()
        np.testing.assert_array_equal(words, want)
    assert (want[4] == 0).all() and want[0].any()
    for bad in ([[0, 0, n + 1]], [[len(rows), 0, 1]], [[-1, 0, 1]], [[0, -1, 1]]):
        bad = np.asarray(bad, np.int64)  # outside the postings or the rows: refused
        assert host_index_kernels.m3_index_bitmap_spans_host(
            data.ctypes.data, n, bad.ctypes.data, 1, 0, words.ctypes.data, len(rows),
            n_words) == -2
        with pytest.raises(ValueError, match="outside"):
            tk.bitmap_from_spans(i32(data), bad, len(rows), n_words)
    for r, sp in enumerate(rows):  # each row is the range form's OR of its spans
        acc = np.zeros(n_words, np.int32)
        for a, b in sp:
            acc |= tk.bitmap_from_term_range_reference(i32(data), a, min(b, n), n_words).numpy()
        np.testing.assert_array_equal(want[r], acc)


# ---------- executor parity ----------


def test_sealed_parity_fixed_queries():
    store, ix, jix = both([corpus_batch(4000, seed=1)], T0 + 2 * HOUR)
    assert store.stats()["admissions"] == 1
    for spec in QUERIES:
        assert_parity(ix, spec, jix=jix)
    st = store.stats()
    assert st["search_hits"] == len(QUERIES) and st["search_misses"] == 0
    assert st["errors"] == 0


def test_parity_across_seal_boundary():
    """Mixed mutable + device-sealed segments in one block union: the
    executor routes per segment and still dedupes across them."""
    store, ix, jix = both([corpus_batch(1500, seed=2)], T0 + 2 * HOUR)
    extra = corpus_batch(500, seed=3) + [
        (b"x%d" % i, ((b"name", b"metric_3"), (b"dc", b"dc9")), T0) for i in range(50)]
    ix.write_batch(extra)
    jix.write_batch(extra)
    for spec in QUERIES + [("term", b"dc", b"dc9")]:
        assert_parity(ix, spec, jix=jix)


def rand_spec(rng, depth):
    fields = [b"name", b"host", b"dc", b"role", b"absent"]
    roll = rng.random()
    if depth <= 0 or roll < 0.45:
        leaf = rng.random()
        if leaf < 0.4:
            value = rng.choice([b"metric_%d" % rng.randrange(25), b"h%04d" % rng.randrange(200),
                                b"dc%d" % rng.randrange(4), b"db", b"", b"ab", b"abc"])
            return ("term", rng.choice(fields), value)
        if leaf < 0.8:
            pattern = rng.choice([b"metric_1[0-9]", b"metric_.*", b"h00.*", b"dc(0|2)", b"db.*",
                                  b"metric_1|metric_2|h0001", b".*_3", b"[dw]b.*",
                                  b"metric_%d" % rng.randrange(25)])
            return ("re", rng.choice(fields), pattern)
        if leaf < 0.9:
            return ("field", rng.choice(fields))
        return ("all",)
    subs = [rand_spec(rng, depth - 1) for _ in range(rng.randrange(2, 4))]
    if roll < 0.65:
        return ("conj", *subs)
    if roll < 0.85:
        return ("disj", *subs)
    return ("neg", subs[0])


@pytest.mark.parametrize("seed", range(5))
def test_random_ast_property_suite(seed):
    """Randomized corpora x randomized ASTs: the port's device executor
    (twins) == m3_tpu's device executor (XLA on the CPU) == the port's
    host executor, with and without a limit."""
    rng = random.Random(100 + seed)
    batches = [corpus_batch(800 + 700 * seed, seed=seed)]
    if seed % 2:  # a mutable remainder in a later block
        batches.append(corpus_batch(300, seed=seed + 50, t=T0 + HOUR))
    store, ix, jix = both(batches, T0 + HOUR)  # seals block 0 only
    for _ in range(25):
        assert_parity(ix, rand_spec(rng, 2), limit=rng.choice([None, None, 10, 100]), jix=jix)
    assert store.stats()["errors"] == 0 and store.stats()["search_hits"] == 25


def test_prematch_resolves_every_segment_in_one_launch(monkeypatch):
    """Two resident segments: one K1 call for the query's exact leaves of
    both, and the same doc ids as each segment's own match."""
    store, ix, jix = both([corpus_batch(900, seed=4), corpus_batch(700, seed=5, t=T0 + HOUR)],
                          T0 + 3 * HOUR)
    assert store.stats()["admissions"] == 2
    calls = []
    real = tk.match_terms
    monkeypatch.setattr(tk, "match_terms", lambda *a: calls.append(a[4].shape) or real(*a))
    spec = ("conj", ("term", b"dc", b"dc1"), ("re", b"name", b"metric_1|metric_2|metric_9"),
            ("neg", ("term", b"role", b"db")))
    dev = assert_parity(ix, spec, jix=jix)
    assert len(calls) == 1 and calls[0][0] == 2 * 5  # 2 segments x 5 leaves
    segs = [s for b in ix.blocks.values() for s in b.segments]
    pm = batch.prematch(segs, build_query(tq, spec))
    for s in segs:
        assert set(pm[id(s)][1]) and pm[id(s)][0] is s._arrays
    assert len(dev) > 0


def test_one_k2_call_per_segment_and_query(monkeypatch):
    """Every leaf of a query on a resident segment (terms, alternations,
    prefixes, general regexps, fields, under conjunctions, disjunctions and
    negations) takes ONE K2 call, a bitmap row a leaf; a query with no
    leaf takes none. Same doc ids as the host and m3_tpu."""
    store, ix, jix = both([corpus_batch(900, seed=31), corpus_batch(500, seed=32, t=T0 + HOUR)],
                          T0 + 3 * HOUR)
    calls = []
    real = tk.bitmap_from_spans
    monkeypatch.setattr(tk, "bitmap_from_spans",
                        lambda pd, spans, n_rows, nw: calls.append(n_rows) or real(pd, spans,
                                                                                   n_rows, nw))
    specs = [
        ("term", b"dc", b"dc1"),
        ("conj", ("term", b"dc", b"dc1"), ("re", b"name", b"metric_1|metric_2"),
         ("neg", ("re", b"host", b"h00.*")), ("field", b"role")),
        ("disj", ("re", b"role", b".*b"), ("term", b"name", b"metric_3"), ("re", b"host", b"h1.*")),
        ("neg", ("conj", ("term", b"absent", b"x"), ("field", b"dc"))),
    ]
    for spec in specs:
        calls.clear()
        assert_parity(ix, spec, jix=jix)
        assert len(calls) == 2, spec  # one per resident segment
    assert calls[-1] == 2
    calls.clear()
    assert_parity(ix, ("all",), jix=jix)
    assert calls == []
    assert store.stats()["errors"] == 0 and store.stats()["search_misses"] == 0


def test_unsupported_node_routes_before_any_k2_call(monkeypatch):
    """A node the device does not model is found in the span pass, before
    K2 runs: the search returns None (a counted miss) without a call."""

    class Unmodelled(tq.Query):
        pass

    store = make_store()
    ix = make_index(store)
    ix.write_batch(corpus_batch(200, seed=33))
    ix.seal_before(T0 + 2 * HOUR)
    calls = []
    monkeypatch.setattr(tk, "bitmap_from_spans", lambda *a: calls.append(a))
    seg = next(s for b in ix.blocks.values() for s in b.segments)
    q = tq.conj(tq.term(b"dc", b"dc1"), tq.regexp(b"role", b".*b"), Unmodelled())
    before = store.stats()["search_misses"]
    assert seg.search_ast(q) is None
    assert calls == [] and store.stats()["search_misses"] == before + 1
    assert store.stats()["errors"] == 0


def test_multichip_dryrun_regexp_parity():
    """A 65k-series index, a regexp matching a ~5% slice (the dry run's
    query), resolved by the device executor like the host's."""
    seg = MutableSegment()
    for i in range(65536 + 3):
        seg.insert(Document(b"s%d" % i, ((b"name", b"metric_%d" % (i % 97)),
                                         (b"dc", b"dc%d" % (i % 3)))))
    store = make_store()
    ix = make_index(store)
    ix._block_for(T0).mutable = seg
    ix.seal_before(T0 + 2 * HOUR)
    assert store.stats()["admissions"] == 1
    assert len(assert_parity(ix, ("re", b"name", b"metric_1[0-4]"))) >= 3000
    assert store.stats()["search_hits"] == 1


def test_newline_term_prefix_regexp_parity():
    """Host `.` does not match \\n: a term containing a newline must NOT
    match `pre.*` — the prefix class downgrades to the host-matched
    general path for segments carrying such terms."""
    docs = [(b"a", ((b"name", b"metric_1"),), T0), (b"b", ((b"name", b"metric_\nodd"),), T0),
            (b"c", ((b"name", b"metric_2"),), T0)]
    store, ix, jix = both([docs], T0 + 2 * HOUR)
    assert assert_parity(ix, ("re", b"name", b"metric_.*"), jix=jix) == [b"a", b"c"]
    assert_parity(ix, ("re", b"name", b".*"), jix=jix)
    assert assert_parity(ix, ("term", b"name", b"metric_\nodd"), jix=jix) == [b"b"]


# ---------- residency lifecycle: eviction, rejection, persistence ----------


def test_eviction_falls_back_seamlessly():
    store, ix, jix = both([corpus_batch(600, seed=4, t=T0), corpus_batch(600, seed=5, t=T0 + HOUR)],
                          T0 + 3 * HOUR)
    assert store.stats()["admissions"] == 2
    store.options.max_bytes = store.stats()["bytes"] // 2 + 64  # one segment
    for x in (ix, jix):
        x.write_batch(corpus_batch(600, seed=6, t=T0 + 2 * HOUR))
        x.seal_before(T0 + 4 * HOUR)
    assert store.stats()["evictions"] >= 1
    states = sorted(s.status() for b in ix.blocks.values() for s in b.sealed)
    assert "evicted" in states and "resident" in states
    for spec in QUERIES[:8]:
        assert_parity(ix, spec, jix=jix)
    st = store.stats()
    assert st["search_misses"] > 0, "evicted segments route to the host"
    assert st["errors"] == 0


def test_term_too_long_rejected_not_wrong():
    # one term over the 64-byte key cap that both packages share
    docs = [(b"s%d" % i, ((b"name", b"metric_1"), (b"blob", b"v" * 80)), T0) for i in range(20)]
    store, ix, jix = both([docs], T0 + 2 * HOUR)
    st = store.stats()
    assert st["rejections"] == 1 and st["admissions"] == 0
    (seg,) = ix.blocks[T0 // HOUR * HOUR].sealed
    assert seg.status() == "not-admitted:term-too-long"
    assert_parity(ix, ("term", b"blob", b"v" * 80), jix=jix)
    assert_parity(ix, ("term", b"name", b"metric_1"), jix=jix)
    assert store.stats()["search_misses"] == 2


def test_over_budget_segment_rejected():
    store, ix, jix = both([corpus_batch(500, seed=7)], T0 + 2 * HOUR, max_bytes=128)
    st = store.stats()
    assert st["admissions"] == 0 and st["rejections"] == 1
    for spec in QUERIES[:5]:
        assert_parity(ix, spec, jix=jix)


def test_persist_reload_parity(tmp_path):
    base = str(tmp_path)
    store, ix, jix = both([corpus_batch(1200, seed=8)], T0 + 2 * HOUR)
    ix.persist_before(base, "ns", T0 + 2 * HOUR)
    # the persisted DiskSegment replaced the in-memory one and was
    # re-admitted; the replaced segment's device tier was released
    st = store.stats()
    assert st["admissions"] == 2 and st["invalidations"] >= 1
    assert st["segments"] == 1
    for spec in QUERIES:
        assert_parity(ix, spec, jix=jix)
    store2 = make_store()
    ix2 = make_index(store2)
    assert ix2.load_persisted(base, "ns")
    assert store2.stats()["admissions"] == 1
    for spec in QUERIES:
        assert ids(ix2.query(build_query(tq, spec), *SPAN)) == ids(
            ix.query(build_query(tq, spec), *SPAN)), spec


def test_admission_racing_retention_never_publishes(monkeypatch):
    """A block expired between seal and admission publish must NOT pin a
    device tier in the store."""
    store = make_store()
    ix = make_index(store)
    ix.write_batch(corpus_batch(200, seed=20))
    real_admit = store.admit

    def race_admit(host_seg, **kw):
        ix.evict_before(T0 + 2 * HOUR)  # retention expiry during the upload
        return real_admit(host_seg, **kw)

    monkeypatch.setattr(store, "admit", race_admit)
    ix.seal_before(T0 + 2 * HOUR)
    st = store.stats()
    assert st["segments"] == 0 and st["bytes"] == 0
    assert ids(ix.query(tq.AllQuery(), *SPAN)) == []


@pytest.mark.parametrize("where", ["match_terms", "bitmap_from_terms", "bitmap_from_term_range"])
def test_device_fault_raises(monkeypatch, where):
    """The port's counterpart of m3_tpu's test_device_error_counts_as_miss:
    a device fault is counted as an error and RAISED, never answered from
    the host (the reference degrades it to a host answer)."""
    store = make_store()
    ix = make_index(store)
    ix.write_batch(corpus_batch(200, seed=21))
    ix.seal_before(T0 + 2 * HOUR)

    def boom(*a, **kw):
        raise RuntimeError("injected device fault")

    # K2 is one span-list wrapper; the two ids fault it on a term-list leaf
    # and on a range leaf
    monkeypatch.setattr(tk, "match_terms" if where == "match_terms" else "bitmap_from_spans", boom)
    spec = {"match_terms": ("term", b"dc", b"dc1"),
            "bitmap_from_terms": ("term", b"dc", b"dc1"),
            "bitmap_from_term_range": ("re", b"name", b"metric_.*")}[where]
    with pytest.raises(RuntimeError, match="injected device fault"):
        ix.query(build_query(tq, spec), *SPAN)
    st = store.stats()
    assert st["errors"] == 1 and st["search_hits"] == 0 and st["search_misses"] == 0
    # the host executor is still there when asked for
    assert ids(ix.query(build_query(tq, spec), *SPAN, force_host=True))


def test_batched_match_fault_raises(monkeypatch):
    store, ix, _ = both([corpus_batch(300, seed=22), corpus_batch(300, seed=23, t=T0 + HOUR)],
                        T0 + 3 * HOUR)

    def boom(*a, **kw):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(tk, "match_terms", boom)
    with pytest.raises(RuntimeError, match="injected device fault"):
        ix.query(tq.term(b"dc", b"dc1"), *SPAN)


def test_retention_eviction_releases_device_tier():
    store = make_store()
    ix = make_index(store)
    ix.write_batch(corpus_batch(400, seed=9))
    ix.seal_before(T0 + 2 * HOUR)
    assert len(store) == 1
    ix.evict_before(T0 + 2 * HOUR)
    st = store.stats()
    assert st["invalidations"] == 1 and st["segments"] == 0 and st["bytes"] == 0
    assert ids(ix.query(tq.AllQuery(), *SPAN)) == []


def test_postings_cache_counters_and_invalidation(tmp_path):
    from m3_tpu_torch.index.postings_cache import _M_HITS, _M_MISSES

    ix = make_index()  # host-only: the cache serves the host executor
    ix.write_batch(corpus_batch(800, seed=10))
    ix.seal_before(T0 + 2 * HOUR)
    q = tq.regexp(b"name", b"metric_1[0-9]")
    h0, m0 = _M_HITS.value, _M_MISSES.value
    first = ids(ix.query(q, *SPAN))
    assert _M_MISSES.value > m0
    assert ids(ix.query(q, *SPAN)) == first
    assert _M_HITS.value > h0, "repeat regexp must serve from the cache"
    assert ix.postings_cache.stats()["entries"] > 0
    ix.persist_before(str(tmp_path), "ns", T0 + 2 * HOUR)
    st = ix.postings_cache.stats()
    assert st["invalidations"] > 0 and st["entries"] == 0


def test_postings_cache_invalidate_on_retention():
    ix = make_index()
    ix.write_batch(corpus_batch(300, seed=11))
    ix.seal_before(T0 + 2 * HOUR)
    ids(ix.query(tq.FieldQuery(b"host"), *SPAN))
    assert ix.postings_cache.stats()["entries"] > 0
    ix.evict_before(T0 + 2 * HOUR)
    assert ix.postings_cache.stats()["entries"] == 0


# ---------- options and the device rule ----------


def test_options_validate_and_one_config_error():
    assert PoolConfigError is ConfigError
    with pytest.raises(ConfigError):
        IndexDeviceOptions(max_bytes=-1).validate()
    IndexDeviceOptions(max_bytes=1).validate()
    assert DeviceIndexStore(device="cpu").enabled, "a store is on by default"
    store = DeviceIndexStore(IndexDeviceOptions(max_bytes=0), device="cpu")
    ix = make_index(store)
    ix.write_batch(corpus_batch(50, seed=12))
    ix.seal_before(T0 + 2 * HOUR)
    (seg,) = ix.blocks[T0 // HOUR * HOUR].sealed
    assert seg.status() == "not-admitted:disabled"


def test_store_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceIndexStore(IndexDeviceOptions(max_bytes=1 << 20))
