"""Inverted index segments: mutable ingest segment + sealed immutable segment.

Reference: M3's src/m3ninx/ — doc model (doc/), mutable segment
(index/segment/mem: concurrent postings map field→term→roaring bitmap),
immutable FST segment (index/segment/fst: fields FST → terms FST → postings
bitsets, mmap'd), segment builder (index/segment/builder merges segments).

A copy of ``m3_tpu/index/segment.py`` (same classes, same serialized
bytes). Postings are sorted int32 numpy arrays (the role roaring bitmaps
play), term dictionaries are sorted arrays searched by np.searchsorted (the
role the FST plays), and set algebra is vectorized numpy, all on the host;
a sealed segment's device tier is ``index/device/``.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field

import numpy as np

from ..block.core import Tags


@dataclass(frozen=True)
class Document:
    """doc.Document{ID, Fields} (m3ninx/doc/document.go)."""

    id: bytes
    fields: Tags


def _top_level_alternation(pattern: bytes) -> bool:
    """True if the pattern has an unparenthesized '|' — then NO prefix is
    common to all alternatives and pruning is unsafe."""
    depth = 0
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == 0x5C:  # backslash: skip escaped char
            i += 2
            continue
        if in_class:
            if c == 0x5D:  # ]
                in_class = False
        elif c == 0x5B:  # [
            in_class = True
        elif c == 0x28:  # (
            depth += 1
        elif c == 0x29:  # )
            depth -= 1
        elif c == 0x7C and depth == 0:  # |
            return True
        i += 1
    return False


# regexp metacharacters — ONE definition shared by the host prefix prune
# below and the device executor's pattern classification
# (index/device/segment.py): if the sets diverged, the device literal/
# prefix classes would silently disagree with the host prune the
# bit-identity contract depends on
REGEXP_SPECIALS = b".^$*+?{}[]|()\\"


def literal_prefix(pattern: bytes) -> bytes:
    """Longest literal prefix of a regexp — the prune the reference gets
    from intersecting the compiled automaton with the term FST
    (segment/fst/regexp/regexp.go): only terms in [prefix, next(prefix))
    can match, so the scan touches a fraction of the dictionary."""
    if pattern.startswith(b"^"):
        pattern = pattern[1:]
    if _top_level_alternation(pattern):
        return b""
    out = bytearray()
    i = 0
    while i < len(pattern):
        c = pattern[i : i + 1]
        if c in REGEXP_SPECIALS:
            break
        out += c
        i += 1
    # a quantifier after the last literal makes that char optional
    if i < len(pattern) and pattern[i : i + 1] in b"*+?{" and out:
        out = out[:-1]
    return bytes(out)


def prefix_upper(pre: bytes) -> bytes | None:
    """Smallest byte string greater than every string with prefix ``pre``
    (None if unbounded)."""
    b = bytearray(pre)
    while b:
        if b[-1] < 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return None


class MutableSegment:
    """segment/mem: built live on ingest."""

    def __init__(self) -> None:
        self.docs: list[Document] = []
        self._ids: dict[bytes, int] = {}
        self._postings: dict[tuple[bytes, bytes], list[int]] = {}
        self._fields: dict[bytes, set[bytes]] = {}

    def __len__(self) -> int:
        return len(self.docs)

    def insert(self, doc: Document) -> int:
        existing = self._ids.get(doc.id)
        if existing is not None:
            return existing
        idx = len(self.docs)
        self.docs.append(doc)
        self._ids[doc.id] = idx
        for name, value in doc.fields:
            self._postings.setdefault((name, value), []).append(idx)
            self._fields.setdefault(name, set()).add(value)
        return idx

    def postings(self, name: bytes, value: bytes) -> np.ndarray:
        return np.asarray(self._postings.get((name, value), []), np.int32)

    def terms(self, name: bytes) -> list[bytes]:
        return sorted(self._fields.get(name, ()))

    def fields(self) -> list[bytes]:
        return sorted(self._fields)

    def seal(self) -> "SealedSegment":
        return SealedSegment.from_mutable(self)


class SealedSegment:
    """Immutable segment: sorted term dict per field + packed postings —
    the fst segment's role (segment/fst/segment.go) in array form."""

    def __init__(self, docs, field_terms, postings_index, postings_data) -> None:
        self.docs: list[Document] = docs
        # field -> (sorted term list, [start, end) into postings_data per term)
        self._field_terms: dict[bytes, list[bytes]] = field_terms
        self._postings_index: dict[bytes, np.ndarray] = postings_index  # [n_terms, 2]
        self._postings_data: np.ndarray = postings_data  # int32 concatenated
        # per-field object arrays for searchsorted, built once — rebuilding
        # them per postings() call made persist O(n_terms^2)
        self._term_arrs: dict[bytes, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.docs)

    def _term_arr(self, name: bytes) -> np.ndarray | None:
        arr = self._term_arrs.get(name)
        if arr is None:
            terms = self._field_terms.get(name)
            if not terms:
                return None
            arr = np.asarray(terms, object)
            self._term_arrs[name] = arr
        return arr

    @staticmethod
    def from_mutable(seg: MutableSegment) -> "SealedSegment":
        field_terms: dict[bytes, list[bytes]] = {}
        postings_index: dict[bytes, np.ndarray] = {}
        chunks: list[np.ndarray] = []
        offset = 0
        for name in seg.fields():
            terms = seg.terms(name)
            field_terms[name] = terms
            idx = np.zeros((len(terms), 2), np.int64)
            for i, t in enumerate(terms):
                p = seg.postings(name, t)
                chunks.append(p)
                idx[i] = (offset, offset + len(p))
                offset += len(p)
            postings_index[name] = idx
        data = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
        return SealedSegment(list(seg.docs), field_terms, postings_index, data)

    def fields(self) -> list[bytes]:
        return sorted(self._field_terms)

    def terms(self, name: bytes) -> list[bytes]:
        return self._field_terms.get(name, [])

    def postings(self, name: bytes, value: bytes) -> np.ndarray:
        arr = self._term_arr(name)
        if arr is None:
            return np.zeros(0, np.int32)
        terms = self._field_terms[name]
        i = np.searchsorted(arr, value)
        if i >= len(terms) or terms[i] != value:
            return np.zeros(0, np.int32)
        s, e = self._postings_index[name][i]
        return self._postings_data[s:e]

    def iter_term_postings(self, name: bytes):
        """(term, postings) pairs in sorted term order — the segment
        writer's walk, without a per-term search."""
        idx = self._postings_index.get(name)
        for i, t in enumerate(self._field_terms.get(name, [])):
            s, e = idx[i]
            yield t, self._postings_data[s:e]

    def postings_regexp(self, name: bytes, pattern: bytes) -> np.ndarray:
        """segment/fst/regexp: regex → automaton intersected with the term
        dict; here literal-prefix pruning narrows the sorted dict to the
        only range that can match, then a compiled re filters it."""
        arr = self._term_arr(name)
        if arr is None:
            return np.zeros(0, np.int32)
        terms = self._field_terms[name]
        lo, hi = 0, len(terms)
        pre = literal_prefix(pattern)
        if pre:
            lo = int(np.searchsorted(arr, pre))
            up = prefix_upper(pre)
            hi = int(np.searchsorted(arr, up)) if up is not None else len(terms)
        rx = re.compile(b"^(?:" + pattern + b")$")
        out = []
        idx = self._postings_index[name]
        for i in range(lo, hi):
            if rx.match(terms[i]):
                s, e = idx[i]
                out.append(self._postings_data[s:e])
        if not out:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(out))

    # --- persistence (m3ninx/persist segment file sets) ---

    def serialize(self) -> bytes:
        from ..utils.serialize import encode_tags

        parts = [struct.pack("<I", len(self.docs))]
        for d in self.docs:
            enc_fields = encode_tags(d.fields)
            parts.append(struct.pack("<II", len(d.id), len(enc_fields)))
            parts.append(d.id)
            parts.append(enc_fields)
        parts.append(struct.pack("<I", len(self._field_terms)))
        for name in self.fields():
            terms = self._field_terms[name]
            idx = self._postings_index[name]
            parts.append(struct.pack("<II", len(name), len(terms)))
            parts.append(name)
            for i, t in enumerate(terms):
                parts.append(struct.pack("<IQQ", len(t), idx[i][0], idx[i][1]))
                parts.append(t)
        raw = self._postings_data.astype("<i4").tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
        return b"".join(parts)

    @staticmethod
    def deserialize(buf: bytes) -> "SealedSegment":
        from ..utils.serialize import decode_tags

        pos = 0
        (n_docs,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        docs = []
        for _ in range(n_docs):
            id_len, f_len = struct.unpack_from("<II", buf, pos)
            pos += 8
            did = buf[pos : pos + id_len]
            pos += id_len
            enc = buf[pos : pos + f_len]
            pos += f_len
            docs.append(Document(did, decode_tags(enc)))
        (n_fields,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        field_terms: dict[bytes, list[bytes]] = {}
        postings_index: dict[bytes, np.ndarray] = {}
        for _ in range(n_fields):
            name_len, n_terms = struct.unpack_from("<II", buf, pos)
            pos += 8
            name = buf[pos : pos + name_len]
            pos += name_len
            terms = []
            idx = np.zeros((n_terms, 2), np.int64)
            for i in range(n_terms):
                t_len, s, e = struct.unpack_from("<IQQ", buf, pos)
                pos += 20
                terms.append(buf[pos : pos + t_len])
                pos += t_len
                idx[i] = (s, e)
            field_terms[name] = terms
            postings_index[name] = idx
        (raw_len,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        data = np.frombuffer(buf, "<i4", count=raw_len // 4, offset=pos).copy()
        return SealedSegment(docs, field_terms, postings_index, data)


def merge_segments(segments) -> "SealedSegment":
    """Merge immutable segments into one, deduping docs by id — the
    reference's multi-segment builder used for flush compaction
    (m3ninx/index/segment/builder/multi_segments_*). Doc order follows the
    input segment order (earlier segments win duplicates, matching the
    executor's dedupe)."""
    m = MutableSegment()
    for seg in segments:
        docs = seg.docs
        for i in range(len(seg)):
            m.insert(docs[i])
    return m.seal()
