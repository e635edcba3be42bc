"""Index query AST + executor.

Reference: M3's src/m3ninx/ — idx.Query builders (idx/), searchers
(search/searcher/: term, regexp, conjunction, disjunction, negation, all,
empty, field) and executor (search/executor/) iterating matches across
segments.

A copy of ``m3_tpu/index/query.py``. One difference is the device tier's:
a device fault raises out of ``search_segment`` instead of turning into a
host answer (``index/device/segment.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .segment import Document


@dataclass(frozen=True)
class Query:
    pass


@dataclass(frozen=True)
class TermQuery(Query):
    field: bytes
    value: bytes


@dataclass(frozen=True)
class RegexpQuery(Query):
    field: bytes
    pattern: bytes


@dataclass(frozen=True)
class FieldQuery(Query):
    """Matches docs that have the field at all (searcher/field.go)."""

    field: bytes


@dataclass(frozen=True)
class AllQuery(Query):
    pass


@dataclass(frozen=True)
class ConjunctionQuery(Query):
    queries: tuple[Query, ...]


@dataclass(frozen=True)
class DisjunctionQuery(Query):
    queries: tuple[Query, ...]


@dataclass(frozen=True)
class NegationQuery(Query):
    query: Query


def term(field: bytes, value: bytes) -> TermQuery:
    return TermQuery(field, value)


def regexp(field: bytes, pattern: bytes) -> RegexpQuery:
    return RegexpQuery(field, pattern)


def conj(*qs: Query) -> ConjunctionQuery:
    return ConjunctionQuery(tuple(qs))


def disj(*qs: Query) -> DisjunctionQuery:
    return DisjunctionQuery(tuple(qs))


def neg(q: Query) -> NegationQuery:
    return NegationQuery(q)


def search_segment(seg, query: Query, cache=None, prematched=None) -> np.ndarray:
    """Postings for one segment (search/searcher dispatch); sorted unique.

    A device-resident segment (index/device/segment.py DeviceSegment)
    evaluates the WHOLE AST on device — bitmap algebra instead of the
    sorted merges below — with bit-identical results; when its tier is
    evicted / was never admitted, or the AST holds a node it does not
    model, it answers None and the segment falls through to this host path
    (the wrapper implements the full sealed surface by delegation). A
    device fault raises.

    ``cache`` is a PostingsListCache: regexp/field scans over IMMUTABLE
    segments are O(total terms) to compute, so repeated queries serve from
    the LRU (postings_list_cache.go:59). The device path skips it — a
    bitmap recompute is cheaper than uploading a cached array back."""
    if hasattr(seg, "search_ast"):
        # ``prematched``: this segment's slice of the cross-segment
        # batched leaf match (index/device/batch.py) — all exact leaves
        # of the query resolved in ONE launch across segments
        out = seg.search_ast(query, prematched=prematched)
        if out is not None:
            return out
        seg = seg.host  # transparent host fallback
    if isinstance(query, TermQuery):
        return np.asarray(seg.postings(query.field, query.value), np.int32)
    if isinstance(query, RegexpQuery):
        hit, key = _cache_lookup(cache, seg, ("re", query.field, query.pattern))
        if hit is not None:
            return hit
        if hasattr(seg, "postings_regexp"):
            out = seg.postings_regexp(query.field, query.pattern)
        else:
            import re

            rx = re.compile(b"^(?:" + query.pattern + b")$")
            if hasattr(seg, "postings_for_terms"):
                out = seg.postings_for_terms(query.field, rx.match)
            else:
                found = [
                    np.asarray(seg.postings(query.field, t), np.int32)
                    for t in seg.terms(query.field)
                    if rx.match(t)
                ]
                out = (
                    np.unique(np.concatenate(found))
                    if found
                    else np.zeros(0, np.int32)
                )
        if key is not None:
            cache.put(key, out)
        return out
    if isinstance(query, FieldQuery):
        hit, key = _cache_lookup(cache, seg, ("field", query.field))
        if hit is not None:
            return hit
        if hasattr(seg, "postings_for_terms"):
            out = seg.postings_for_terms(query.field, lambda t: True)
        else:
            found = [
                np.asarray(seg.postings(query.field, t), np.int32)
                for t in seg.terms(query.field)
            ]
            out = (
                np.unique(np.concatenate(found)) if found else np.zeros(0, np.int32)
            )
        if key is not None:
            cache.put(key, out)
        return out
    if isinstance(query, AllQuery):
        return np.arange(len(seg), dtype=np.int32)
    if isinstance(query, ConjunctionQuery):
        if not query.queries:
            return np.zeros(0, np.int32)
        # negations subtract from the positive intersection (idx/query.go)
        pos = [q for q in query.queries if not isinstance(q, NegationQuery)]
        negs = [q for q in query.queries if isinstance(q, NegationQuery)]
        if pos:
            acc = search_segment(seg, pos[0], cache)
            for q in pos[1:]:
                acc = np.intersect1d(
                    acc, search_segment(seg, q, cache), assume_unique=False
                )
        else:
            acc = np.arange(len(seg), dtype=np.int32)
        for q in negs:
            acc = np.setdiff1d(
                acc, search_segment(seg, q.query, cache), assume_unique=False
            )
        return acc.astype(np.int32)
    if isinstance(query, DisjunctionQuery):
        out = [search_segment(seg, q, cache) for q in query.queries]
        out = [o for o in out if len(o)]
        return np.unique(np.concatenate(out)).astype(np.int32) if out else np.zeros(0, np.int32)
    if isinstance(query, NegationQuery):
        return np.setdiff1d(
            np.arange(len(seg), dtype=np.int32), search_segment(seg, query.query, cache)
        ).astype(np.int32)
    raise TypeError(f"unknown query {query!r}")


def _cache_lookup(cache, seg, subkey):
    """(cached postings | None, cache key | None)."""
    if cache is None:
        return None, None
    from .postings_cache import segment_cache_key

    sk = segment_cache_key(seg)
    if sk is None:
        return None, None
    key = (sk,) + subkey
    return cache.get(key), key


class MatchedDocs:
    """Lazy matched-document sequence (search/executor iterator role).

    Postings are computed eagerly (cheap, postings-cache-served); Document
    objects materialize only on access — so `len(result.docs)`, id-only
    consumers (series select), and partial iteration never pay the per-doc
    tag decode that dominated large regexp fan-outs (2.5s at 500k docs).
    Cross-segment id-dedupe extracts only ids, via the segment's batch
    ``doc_ids`` fast path when it has one; the common single-segment case
    (ids unique within a segment by construction) skips dedupe entirely."""

    def __init__(self, parts, limit: int | None = None) -> None:
        """``parts`` is an ITERABLE of (segment, postings): it is consumed
        lazily so a satisfied ``limit`` stops searching later segments
        entirely (the executor's early exit). Id-dedupe engages only once a
        SECOND non-empty segment appears — the common single-segment case
        never extracts ids at all."""
        self._parts: list = []
        seen: set[bytes] | None = None
        total = 0
        for seg, post in parts:
            if limit is not None and total >= limit:
                break
            if not len(post):
                continue
            if self._parts and seen is None:
                # second live part: seed the dedupe set from earlier parts
                seen = set()
                for s0, p0 in self._parts:
                    seen.update(self._ids_of(s0, p0))
            if seen is None:
                if limit is not None and total + len(post) > limit:
                    post = post[: limit - total]
                self._parts.append((seg, post))
                total += len(post)
            else:
                ids = self._ids_of(seg, post)
                keep = []
                for j, did in enumerate(ids):
                    if did in seen:
                        continue
                    seen.add(did)
                    keep.append(j)
                    total += 1
                    if limit is not None and total >= limit:
                        break
                self._parts.append(
                    (seg, post[np.asarray(keep, np.int64)] if keep else post[:0])
                )
        self._len = total
        self._offsets = np.cumsum([0] + [len(p) for _, p in self._parts])

    @staticmethod
    def _ids_of(seg, post):
        if hasattr(seg, "doc_ids"):
            return seg.doc_ids(post)
        docs = seg.docs
        return [docs[int(i)].id for i in post]

    def ids(self) -> list[bytes]:
        """All matched doc ids without tag materialization."""
        out: list[bytes] = []
        for seg, post in self._parts:
            out.extend(self._ids_of(seg, post))
        return out

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._len))]
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        k = int(np.searchsorted(self._offsets, i, side="right")) - 1
        seg, post = self._parts[k]
        return seg.docs[int(post[i - int(self._offsets[k])])]

    def __iter__(self):
        for seg, post in self._parts:
            docs = seg.docs
            for i in post:
                yield docs[int(i)]


def execute(segments, query: Query, limit: int | None = None, cache=None,
            prematched=None) -> MatchedDocs:
    """search/executor: matched docs across segments as a LAZY sequence
    (docs dedupe by id — later segments don't re-emit ids already seen).
    Segments are searched lazily: once ``limit`` is reached, remaining
    segments are never scanned. ``prematched`` maps id(segment) to its
    slice of a cross-segment batched leaf match (device/batch.py)."""
    pm = prematched or {}
    return MatchedDocs(
        (
            (seg, search_segment(seg, query, cache, prematched=pm.get(id(seg))))
            for seg in segments
        ),
        limit=limit,
    )
