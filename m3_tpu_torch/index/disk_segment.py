"""Immutable on-disk index segments, mmap'd and zero-copy.

Reference: M3's src/m3ninx/index/segment/fst/ — the reference
seals mutable segments into mmap'd FST files (segment.go:181: fields FST →
terms FST → postings offsets → bitsets) so an index block's memory cost is
page-cache, not heap, and opening a segment is O(1). This framework's
equivalent keeps the same contract with array-first machinery instead of
FSTs: a single file holding

    header        magic, version, n_docs, n_terms, section table
    fields table  name → [term_start, term_count) into the global term dict
    term offsets  u64[n_terms+1] into the terms blob (per-field sorted)
    terms blob    concatenated term bytes
    postings idx  u64[n_terms, 2] → [start, end) into postings data
    postings data i32[total] ascending doc ids per term
    ids index     u64[n_docs+1] into the ids blob
    ids blob      concatenated doc id bytes
    columns       i32[n_fields, n_docs] — doc's GLOBAL term index per field
                  (-1 = field absent), field-major in sorted field order

The doc store is COLUMNAR (v2): a document's tags are (field, term-index)
references into the shared term dictionary, so the whole docs section is
built by inverting the postings lists with vectorized numpy scatters (no
per-doc Python encode, which v1's per-doc tag blobs need) and a doc materializes zero-copy off the term blob. Term lookup is binary
search over the offset table (the FST's job); regexp scans narrow to the
literal-prefix range first (the automaton∩FST prune, fst/regexp/regexp.go).

``DiskSegment`` implements the SealedSegment surface (len/fields/terms/
postings/docs) so the search executor and aggregate queries run on it
unchanged; v1 files (per-doc tag blobs) remain readable.

A copy of ``m3_tpu/index/disk_segment.py``: the same file format, so a
file written by either package opens in the other.
"""

from __future__ import annotations

import os
import re as _re
import struct
from bisect import bisect_left

import numpy as np

from ..utils.serialize import decode_tags, encode_tags
from .segment import Document, literal_prefix, prefix_upper

MAGIC = 0x4D334658  # "M3FX"
VERSION = 2
V1 = 1

_HDR = struct.Struct("<IIQQ")  # magic, version, n_docs, n_terms
_SECT = struct.Struct("<QQ")  # offset, length
(S_FIELDS, S_TERM_OFFS, S_TERMS, S_POST_IDX, S_POST_DATA, S_IDS_IDX, S_IDS,
 S_COLS) = range(8)
_N_SECTS = {V1: 7, VERSION: 8}


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _header_len(version: int) -> int:
    return _HDR.size + _N_SECTS[version] * _SECT.size


def _iter_term_postings(seg, name: bytes):
    if hasattr(seg, "iter_term_postings"):
        yield from seg.iter_term_postings(name)
    else:
        for t in seg.terms(name):
            yield t, seg.postings(name, t)


def write_disk_segment(path: str, seg) -> str:
    """Serialize any sealed-surface segment to the mmap format; atomic
    replace (persist crash-safety: a torn write never shadows the old
    file). Falls back to the v1 per-doc layout if any doc carries two
    values for one field (the columnar store holds one term per field)."""
    n_docs = len(seg)
    term_blobs: list[bytes] = []
    term_offs: list[int] = [0]
    post_idx: list[tuple[int, int]] = []
    post_chunks: list[np.ndarray] = []
    fields_parts: list[bytes] = []
    cols: list[np.ndarray] = []
    n_terms = 0
    post_off = 0
    blob_off = 0
    field_names = seg.fields()
    for name in field_names:
        col = np.full(n_docs, -1, np.int32)
        assigned = 0
        n_field_terms = 0
        base = n_terms
        for t, p in _iter_term_postings(seg, name):
            t = bytes(t)
            blob_off += len(t)
            term_blobs.append(t)
            term_offs.append(blob_off)
            p = np.asarray(p, np.int32)
            post_chunks.append(p)
            post_idx.append((post_off, post_off + len(p)))
            post_off += len(p)
            col[p] = n_terms  # invert postings → per-doc term reference
            assigned += len(p)
            n_terms += 1
            n_field_terms += 1
        fields_parts.append(
            struct.pack("<I", len(name)) + bytes(name)
            + struct.pack("<QQ", base, n_field_terms)
        )
        if assigned != int(np.count_nonzero(col >= 0)):
            # duplicate field value on some doc: columnar can't hold it
            return _write_disk_segment_v1(path, seg)
        cols.append(col)

    docs_seq = seg.docs
    ids = [bytes(docs_seq[i].id) for i in range(n_docs)]
    ids_blob = b"".join(ids)
    ids_offs = np.zeros(n_docs + 1, "<u8")
    if n_docs:
        np.cumsum(np.fromiter((len(i) for i in ids), np.int64, n_docs),
                  out=ids_offs[1:])

    sections = [
        struct.pack("<I", len(field_names)) + b"".join(fields_parts),
        np.asarray(term_offs, "<u8").tobytes(),
        b"".join(term_blobs),
        np.asarray(post_idx, "<u8").tobytes() if post_idx else b"",
        (np.concatenate(post_chunks) if post_chunks else np.zeros(0, np.int32))
        .astype("<i4")
        .tobytes(),
        ids_offs.tobytes(),
        ids_blob,
        (np.concatenate(cols) if cols else np.zeros(0, np.int32))
        .astype("<i4")
        .tobytes(),
    ]
    return _write_sections(path, VERSION, n_docs, n_terms, sections)


def _write_disk_segment_v1(path: str, seg) -> str:
    """v1 layout: per-doc tag blobs (kept for multi-valued fields)."""
    term_blobs: list[bytes] = []
    term_offs: list[int] = [0]
    post_idx: list[tuple[int, int]] = []
    post_chunks: list[np.ndarray] = []
    fields_parts: list[bytes] = []
    n_terms = 0
    post_off = 0
    blob_off = 0
    for name in seg.fields():
        base = n_terms
        cnt = 0
        for t, p in _iter_term_postings(seg, name):
            t = bytes(t)
            blob_off += len(t)
            term_blobs.append(t)
            term_offs.append(blob_off)
            p = np.asarray(p, np.int32)
            post_chunks.append(p)
            post_idx.append((post_off, post_off + len(p)))
            post_off += len(p)
            n_terms += 1
            cnt += 1
        fields_parts.append(
            struct.pack("<I", len(name)) + bytes(name)
            + struct.pack("<QQ", base, cnt)
        )

    docs_parts: list[bytes] = []
    docs_offs: list[int] = [0]
    off = 0
    n_docs = len(seg)
    docs_seq = seg.docs
    for i in range(n_docs):
        d = docs_seq[i]
        enc = encode_tags(d.fields)
        rec = struct.pack("<I", len(d.id)) + bytes(d.id) + enc
        docs_parts.append(rec)
        off += len(rec)
        docs_offs.append(off)

    sections = [
        struct.pack("<I", len(seg.fields())) + b"".join(fields_parts),
        np.asarray(term_offs, "<u8").tobytes(),
        b"".join(term_blobs),
        np.asarray(post_idx, "<u8").tobytes() if post_idx else b"",
        (np.concatenate(post_chunks) if post_chunks else np.zeros(0, np.int32))
        .astype("<i4")
        .tobytes(),
        np.asarray(docs_offs, "<u8").tobytes(),
        b"".join(docs_parts),
    ]
    return _write_sections(path, V1, n_docs, n_terms, sections)


def _write_sections(path, version, n_docs, n_terms, sections) -> str:
    hdr_len = _header_len(version)
    table = []
    pos = _align8(hdr_len)
    body = []
    for s in sections:
        table.append((pos, len(s)))
        pad = _align8(pos + len(s)) - (pos + len(s))
        body.append(s)
        body.append(b"\0" * pad)
        pos = _align8(pos + len(s))

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        hdr = _HDR.pack(MAGIC, version, n_docs, n_terms)
        hdr += b"".join(_SECT.pack(o, ln) for o, ln in table)
        f.write(hdr)
        f.write(b"\0" * (_align8(hdr_len) - hdr_len))
        for b in body:
            f.write(b)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class _LazyDocs:
    """Sequence view over the doc store (decoded on access only)."""

    def __init__(self, seg: "DiskSegment") -> None:
        self._seg = seg

    def __len__(self) -> int:
        return self._seg._n_docs

    def __getitem__(self, i: int) -> Document:
        return self._seg.doc(i)


class DiskSegment:
    """Zero-copy mmap'd immutable segment (fst/segment.go role)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        buf = self._mm
        magic, version, n_docs, n_terms = _HDR.unpack_from(buf, 0)
        if magic != MAGIC or version not in _N_SECTS:
            raise ValueError(f"bad segment file {path!r}")
        self.version = version
        self._n_docs = int(n_docs)
        self._n_terms = int(n_terms)
        sects = [
            _SECT.unpack_from(buf, _HDR.size + i * _SECT.size)
            for i in range(_N_SECTS[version])
        ]

        def view(i, dtype):
            o, ln = sects[i]
            return np.frombuffer(
                buf, dtype=dtype, count=ln // np.dtype(dtype).itemsize, offset=o
            )

        self._term_offs = view(S_TERM_OFFS, "<u8")
        self._terms_blob = memoryview(buf)[
            sects[S_TERMS][0] : sects[S_TERMS][0] + sects[S_TERMS][1]
        ]
        pi = view(S_POST_IDX, "<u8")
        self._post_idx = pi.reshape(-1, 2) if pi.size else pi.reshape(0, 2)
        self._post_data = view(S_POST_DATA, "<i4")
        self._docs_idx = view(S_IDS_IDX, "<u8")
        self._docs_blob = memoryview(buf)[
            sects[S_IDS][0] : sects[S_IDS][0] + sects[S_IDS][1]
        ]
        # fields table is tiny: parse once at open
        o, ln = sects[S_FIELDS]
        fb = bytes(memoryview(buf)[o : o + ln])
        (n_fields,) = struct.unpack_from("<I", fb, 0)
        pos = 4
        self._fields: dict[bytes, tuple[int, int]] = {}
        for _ in range(n_fields):
            (nl,) = struct.unpack_from("<I", fb, pos)
            pos += 4
            name = fb[pos : pos + nl]
            pos += nl
            start, count = struct.unpack_from("<QQ", fb, pos)
            pos += 16
            self._fields[name] = (int(start), int(count))
        if version >= 2:
            all_cols = view(S_COLS, "<i4")
            self._cols = [
                (name, all_cols[k * self._n_docs : (k + 1) * self._n_docs])
                for k, name in enumerate(sorted(self._fields))
            ]
        else:
            self._cols = None
        self._term_cache: dict[int, bytes] = {}  # gi -> bytes, on demand
        self.docs = _LazyDocs(self)

    # --- sealed-segment surface ---

    def __len__(self) -> int:
        return self._n_docs

    def fields(self) -> list[bytes]:
        return sorted(self._fields)

    def _term(self, gi: int) -> bytes:
        return bytes(self._terms_blob[self._term_offs[gi] : self._term_offs[gi + 1]])

    def terms(self, name: bytes):
        start, count = self._fields.get(name, (0, 0))
        return [self._term(start + i) for i in range(count)]

    def iter_terms(self, name: bytes):
        start, count = self._fields.get(name, (0, 0))
        for i in range(count):
            yield start + i, self._term(start + i)

    def iter_term_postings(self, name: bytes):
        for gi, t in self.iter_terms(name):
            s, e = self._post_idx[gi]
            yield t, self._post_data[s:e]

    def _find_term(self, name: bytes, value: bytes) -> int:
        """Global term index, or -1 (binary search — the FST lookup)."""
        start, count = self._fields.get(name, (0, 0))
        if not count:
            return -1

        class _V:  # bisect over a virtual sorted sequence of term bytes
            def __getitem__(s, i):
                return self._term(start + i)

            def __len__(s):
                return count

        i = bisect_left(_V(), bytes(value))
        if i < count and self._term(start + i) == bytes(value):
            return start + i
        return -1

    def postings(self, name: bytes, value: bytes) -> np.ndarray:
        gi = self._find_term(name, value)
        if gi < 0:
            return np.zeros(0, np.int32)
        s, e = self._post_idx[gi]
        return self._post_data[s:e]

    def postings_regexp(self, name: bytes, pattern: bytes) -> np.ndarray:
        """Literal-prefix-pruned regexp scan over the sorted term range
        (fst/regexp/regexp.go automaton∩FST role)."""
        start, count = self._fields.get(name, (0, 0))
        if not count:
            return np.zeros(0, np.int32)
        lo, hi = 0, count

        class _V:
            def __getitem__(s, i):
                return self._term(start + i)

            def __len__(s):
                return count

        pre = literal_prefix(pattern)
        if pre:
            lo = bisect_left(_V(), pre)
            up = prefix_upper(pre)
            hi = bisect_left(_V(), up) if up is not None else count
        rx = _re.compile(b"^(?:" + pattern + b")$")
        out = []
        for i in range(lo, hi):
            gi = start + i
            if rx.match(self._term(gi)):
                s, e = self._post_idx[gi]
                out.append(self._post_data[s:e])
        if not out:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(out)).astype(np.int32)

    def postings_for_terms(self, name: bytes, predicate) -> np.ndarray:
        """Union of postings for terms matching predicate(term) (field
        searchers / generic scans)."""
        out = []
        for gi, t in self.iter_terms(name):
            if predicate(t):
                s, e = self._post_idx[gi]
                out.append(self._post_data[s:e])
        if not out:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(out)).astype(np.int32)

    def doc_ids(self, postings) -> list[bytes]:
        """Batch doc-id extraction (no tag materialization) — the executor's
        dedupe and the series-select path need only ids."""
        offs = self._docs_idx
        blob = self._docs_blob
        if self.version >= 2:
            return [bytes(blob[offs[i] : offs[i + 1]]) for i in map(int, postings)]
        out = []
        for i in map(int, postings):
            s = int(offs[i])
            (idl,) = struct.unpack_from("<I", blob, s)
            out.append(bytes(blob[s + 4 : s + 4 + idl]))
        return out

    def doc(self, i: int) -> Document:
        s, e = int(self._docs_idx[i]), int(self._docs_idx[i + 1])
        if self.version >= 2:
            did = bytes(self._docs_blob[s:e])
            # term bytes intern lazily per segment: bulk materialization of
            # K docs shares tag-value objects instead of re-slicing the
            # blob K times, while a single-doc lookup only materializes its
            # own few terms
            cache = self._term_cache
            fields = []
            for name, col in self._cols:
                gi = int(col[i])
                if gi < 0:
                    continue
                t = cache.get(gi)
                if t is None:
                    t = cache[gi] = self._term(gi)
                fields.append((name, t))
            return Document(did, tuple(fields))
        rec = bytes(self._docs_blob[s:e])
        (idl,) = struct.unpack_from("<I", rec, 0)
        did = rec[4 : 4 + idl]
        fields = decode_tags(rec[4 + idl :]) if len(rec) > 4 + idl else ()
        return Document(did, tuple(fields))

    def close(self) -> None:
        # memmaps release with the object; explicit close for tests
        self._mm = None
