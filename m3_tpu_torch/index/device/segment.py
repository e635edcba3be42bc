"""Device-resident sealed index segment.

Port of ``m3_tpu/index/device/segment.py``. ``DeviceSegment`` wraps a host
sealed segment (SealedSegment or DiskSegment) and — while its device tier
is resident — answers WHOLE query ASTs on the card: one K1 launch
(batched term search over the packed term-key matrix) for every exact
leaf, one K2 launch (postings union into packed doc bitmaps) for every
leaf's postings spans at once, a bitmap row a leaf, and bitwise
AND/OR/ANDNOT for conjunction/disjunction/negation as torch ops on int32
words (the roaring-bitmap algebra of the reference's m3ninx executor).
The wrapper also implements the full SealedSegment surface by
delegation, so every host consumer (aggregate queries, segment
merge/persist, the host executor) runs on it unchanged.

Routing contract: ``search_ast`` returns EXACTLY the doc-id array the host
executor would produce, or None — the tier is evicted / was never
admitted (its reason on ``status()``), or the AST holds a node the device
does not model — and the executor runs the segment on the host path; each
None is counted as a search miss in the store. Every search records its
route (``index-device`` / ``index-host`` and the reason) in the running
query's routing record (``query/stats.py``), as the reference's does. General regexps keep their
term MATCHING on the host (an automaton cannot become a fixed-width
compare) after the literal-prefix narrow, but the union of the matched
terms' postings and all surrounding set algebra still run on the card.

Where the port differs from the reference: a failed build, a failed launch
or a device fault RAISES. The reference's ``search_ast`` catches any
exception, counts it and answers from the host
(``m3_tpu/index/device/segment.py:259-272``); that would hide a broken
device path behind correct answers. The port counts the fault in the
store's ``errors`` (the reference's counter) and re-raises it.

Regexp classes resolved fully on the card:
- pure literal patterns (a degenerate regexp): batched exact match;
- ``literal.*`` prefixes: the narrowed dictionary range IS the match;
- top-level alternations of literals (``a|b|c``): batched exact match
  of every branch in the same launch.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..query import (
    AllQuery,
    ConjunctionQuery,
    DisjunctionQuery,
    FieldQuery,
    NegationQuery,
    Query,
    RegexpQuery,
    TermQuery,
)
from ..segment import REGEXP_SPECIALS as _SPECIALS
from ..segment import literal_prefix, prefix_upper
from ...query import stats
from . import kernels


class _Unsupported(Exception):
    """AST node the device evaluator does not model — host route."""


def classify_regexp(pattern: bytes):
    """("literal", value) | ("prefix", prefix) | ("alternation",
    [literals]) | ("general", None) — the classes the device can match
    without a host automaton walk. Conservative: anything unclear is
    general."""
    p = pattern[1:] if pattern.startswith(b"^") else pattern
    if p.endswith(b"$"):
        p = p[:-1]
    if not any(c in p for c in _SPECIALS):
        return "literal", p
    if p.endswith(b".*") and not any(c in p[:-2] for c in _SPECIALS):
        return "prefix", p[:-2]
    alt = _literal_alternation(p)
    if alt is not None:
        return "alternation", alt
    return "general", None


def _literal_alternation(p: bytes):
    """Branches of a top-level alternation of plain literals (one
    optional wrapping group allowed), or None."""
    if p.startswith(b"(") and p.endswith(b")"):
        inner = p[1:-1]
        if b"(" not in inner and b")" not in inner:
            p = inner
    if b"|" not in p:
        return None
    branches = p.split(b"|")
    for b in branches:
        if not b or any(c in b for c in _SPECIALS):
            return None
    return branches


class DeviceArrays:
    """The device tier of one sealed segment (built by store.admit from
    ONE host-to-device copy, sliced on the device)."""

    __slots__ = (
        "term_keys", "term_lens", "post_idx", "post_data", "all_words",
        "fields", "k_words", "n_terms", "n_docs", "n_words", "nbytes",
        "host_keys", "host_lens", "host_post_idx", "dot_safe",
        # weak-referenceable: the cross-segment match cache (batch.py)
        # keys entries by arrays identity WITHOUT pinning the tier alive
        "__weakref__",
    )

    def __init__(self, term_keys, term_lens, post_idx, post_data, all_words,
                 fields, k_words, n_docs, n_words, nbytes,
                 host_keys, host_lens, host_post_idx, dot_safe=True) -> None:
        self.term_keys = term_keys  # int32 [n_terms, k_words], u32 bit patterns
        self.term_lens = term_lens  # int32 [n_terms]
        self.post_idx = post_idx  # int32 [n_terms, 2]: [start, end) into post_data
        self.post_data = post_data  # int32 [total postings]
        self.all_words = all_words  # int32 [n_words], tail bits 0
        # name -> (global term start, term count, postings data start,
        # postings data end): a field's terms and its postings run
        self.fields = fields
        self.k_words = k_words
        self.n_terms = int(term_keys.shape[0])
        self.n_docs = n_docs
        self.n_words = n_words
        self.nbytes = nbytes
        # host mirrors: literal-prefix range narrowing and general-regexp
        # candidate walks never touch the device, and K2's launch is sized
        # from the listed terms' postings counts
        self.host_keys = host_keys
        self.host_lens = host_lens
        self.host_post_idx = host_post_idx
        # the `lit.*` fast class treats the narrowed range as the match,
        # but host `.` does NOT match \n — if any term contains one, the
        # class must downgrade to the host-matched general path or the
        # two executors would disagree on exactly that term
        self.dot_safe = dot_safe

    @property
    def device(self) -> torch.device:
        return self.post_data.device


def collect_leaves(query: Query):
    """(leaves [(field, value)], order [(leaf, start_slot, n)], classes
    {id(regexp leaf) -> classification}) for every term / literal-regexp
    / alternation leaf of ``query`` — the batched-binary-search input.
    Shared by the per-segment match below and the CROSS-segment batcher
    (batch.py), which resolves all of a query's exact leaves over every
    device-resident segment in ONE launch."""
    leaves: list[tuple[bytes, bytes]] = []  # (field, value)
    order: list[tuple[Query, int, int]] = []  # (leaf, start_slot, n)
    classes: dict = {}

    def walk(q: Query) -> None:
        if isinstance(q, TermQuery):
            order.append((q, len(leaves), 1))
            leaves.append((q.field, q.value))
        elif isinstance(q, RegexpQuery):
            kind, val = classes[id(q)] = classify_regexp(q.pattern)
            if kind == "literal":
                order.append((q, len(leaves), 1))
                leaves.append((q.field, val))
            elif kind == "alternation":
                order.append((q, len(leaves), len(val)))
                for branch in val:
                    leaves.append((q.field, branch))
        elif isinstance(q, (ConjunctionQuery, DisjunctionQuery)):
            for s in q.queries:
                walk(s)
        elif isinstance(q, NegationQuery):
            walk(q.query)

    walk(query)
    return leaves, order, classes


def match_rows(keys, lens, lo, hi, values, k_words: int, device) -> np.ndarray:
    """One K1 launch over query rows ``values`` with per-row bounds
    (numpy int32 ``lo``/``hi``); rows whose value is wider than the keys
    are unmatchable. The bounds, lengths and key words go up as one int32
    buffer in one copy (from pinned memory on a card); returns the host
    int32 result (one device read)."""
    q_keys, q_lens = kernels.build_query_keys(values, k_words)
    rows = len(values)
    device = torch.device(device)
    host = torch.empty(rows * (3 + k_words), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    np.concatenate([lo, hi, q_lens, q_keys.view(np.int32).ravel()], out=host.numpy())
    buf = host.to(device, non_blocking=True)
    out = kernels.match_terms(keys, lens, buf[:rows], buf[rows : 2 * rows],
                              buf[3 * rows :].view(rows, k_words), buf[2 * rows : 3 * rows])
    return out.cpu().numpy()


class DeviceSegment:
    """SealedSegment-surface wrapper owning a segment's device tier."""

    def __init__(self, host, store, block_start: int | None = None,
                 label: str = "") -> None:
        self.host = host
        self.store = store
        self.block_start = block_start
        self.label = label or f"segment:{id(host):x}"
        # written by the store under ITS lock; read racily on the query
        # path (worst case: one extra host search or one search against a
        # just-evicted tier, both correct)
        self._arrays: DeviceArrays | None = None
        self._state = "pending"
        self._reserved = 0  # budget bytes the store charged for this tier

    # ---- residency / routing ----

    @property
    def resident(self) -> bool:
        return self._arrays is not None

    def status(self) -> str:
        return self._state

    # ---- SealedSegment surface (host delegation) ----

    @property
    def docs(self):
        return self.host.docs

    def __len__(self) -> int:
        return len(self.host)

    def fields(self):
        return self.host.fields()

    def terms(self, name: bytes):
        return self.host.terms(name)

    def postings(self, name: bytes, value: bytes):
        return self.host.postings(name, value)

    def postings_regexp(self, name: bytes, pattern: bytes):
        return self.host.postings_regexp(name, pattern)

    _DELEGATED = frozenset(
        {"doc_ids", "postings_for_terms", "iter_term_postings", "iter_terms",
         "doc", "path", "version"}
    )

    def __getattr__(self, name: str):
        # hasattr-gated optional surface (MatchedDocs probes doc_ids,
        # the executor probes postings_for_terms): present exactly when
        # the host has it
        if name in DeviceSegment._DELEGATED:
            return getattr(self.host, name)
        raise AttributeError(name)

    # ---- device AST evaluation ----

    def search_ast(self, query: Query, prematched=None) -> np.ndarray | None:
        """Doc ids for the whole AST via device bitmaps — bit-identical
        to the host executor — or None to route to the host (evicted /
        not admitted / unsupported node), counted as a miss. A device
        fault is counted in the store's errors and raised.

        ``prematched``: (arrays, gis_map, classes) from the cross-segment
        leaf batcher (batch.py) — used only when its arrays snapshot is
        still THIS segment's tier (an eviction/re-admission between batch
        and search runs a private match, never on stale indices)."""
        arrays = self._arrays
        if arrays is None:
            self.store.count_search(hit=False)
            stats.add_routing(self.label, self.block_start, "index-host", self._state)
            return None
        try:
            note = {"host_regexp": False}
            if prematched is not None and prematched[0] is arrays:
                gis, classes = prematched[1], prematched[2]
            else:
                gis, classes = self._match_leaves(arrays, query)
            bitmap = self._eval(arrays, query, gis, classes, note)
            out = kernels.bitmap_to_docids(bitmap)
        except _Unsupported:
            self.store.count_search(hit=False)
            stats.add_routing(self.label, self.block_start, "index-host", "unsupported-node")
            return None
        except Exception:
            self.store.count_error()
            raise
        self.store.touch(self)
        self.store.count_search(hit=True)
        stats.add_routing(self.label, self.block_start, "index-device",
                          "regexp-host-fallback" if note["host_regexp"] else "")
        return out

    # -- phase 1: batch every exact-match leaf into ONE search launch --

    def _match_leaves(self, arrays: DeviceArrays, query: Query):
        """(id(leaf) -> int32 global term indices, id(regexp leaf) ->
        classification) for every term / literal-regexp / alternation
        leaf, resolved by one K1 launch. Patterns classify ONCE here;
        phase 2 reads the cached class."""
        leaves, order, classes = collect_leaves(query)
        if not leaves:
            return {}, classes
        lo = np.zeros(len(leaves), np.int32)
        hi = np.zeros(len(leaves), np.int32)
        for i, (field, _v) in enumerate(leaves):
            start, count = arrays.fields.get(field, (0, 0, 0, 0))[:2]
            lo[i], hi[i] = start, start + count
        gis = match_rows(arrays.term_keys, arrays.term_lens, lo, hi,
                         [v for _, v in leaves], arrays.k_words, arrays.device)
        out: dict = {}
        for leaf, start, n in order:
            out[id(leaf)] = gis[start : start + n]
        return out, classes

    # -- phase 2: every leaf's postings in ONE K2 launch, then the algebra --

    def _eval(self, arrays: DeviceArrays, q: Query, gis: dict, classes: dict, note: dict):
        """The AST's bitmap in three passes: (1) every K2 leaf's postings
        spans on the host, a bitmap row a leaf (an unsupported node raises
        and a host regexp walk is noted here, before any launch); (2) one
        K2 launch over all the spans; (3) the bitmap algebra over the
        rows."""
        leaf_spans: list[np.ndarray] = []  # row r: int64 [m, 2] (start, end)
        tree = self._plan(arrays, q, gis, classes, note, leaf_spans)
        rows = None
        if leaf_spans:
            spans = np.concatenate([
                np.column_stack([np.full(len(sp), r, np.int64), sp])
                for r, sp in enumerate(leaf_spans)
            ])
            rows = kernels.bitmap_from_spans(arrays.post_data, spans, len(leaf_spans),
                                             arrays.n_words)
        return self._combine(arrays, tree, rows)

    def _plan(self, arrays: DeviceArrays, q: Query, gis: dict, classes: dict, note: dict,
              leaf_spans: list):
        """Pass 1: ``q`` as a tree of ("row", r) leaves — r a bitmap row of
        K2, its spans appended to ``leaf_spans`` — and ("all",), ("zero",),
        ("and", pos, negs), ("or", subs), ("not", sub) nodes."""

        def row(spans):
            leaf_spans.append(np.asarray(spans, np.int64).reshape(-1, 2))
            return ("row", len(leaf_spans) - 1)

        def sub(x):
            return self._plan(arrays, x, gis, classes, note, leaf_spans)

        if isinstance(q, TermQuery):
            return row(kernels.term_spans(arrays.host_post_idx, gis[id(q)]))
        if isinstance(q, RegexpQuery):
            return row(self._regexp_spans(arrays, q, gis, classes, note))
        if isinstance(q, FieldQuery):
            _, _, ds, de = arrays.fields.get(q.field, (0, 0, 0, 0))
            return row([(ds, de)])
        if isinstance(q, AllQuery):
            return ("all",)
        if isinstance(q, ConjunctionQuery):
            if not q.queries:
                return ("zero",)
            pos = [sub(s) for s in q.queries if not isinstance(s, NegationQuery)]
            negs = [sub(s.query) for s in q.queries if isinstance(s, NegationQuery)]
            return ("and", pos, negs)
        if isinstance(q, DisjunctionQuery):
            return ("or", [sub(s) for s in q.queries])
        if isinstance(q, NegationQuery):
            return ("not", sub(q.query))
        raise _Unsupported(type(q).__name__)

    def _combine(self, arrays: DeviceArrays, node, rows):
        """Pass 3: the bitmap of a pass-1 tree over K2's rows."""
        kind = node[0]
        if kind == "row":
            return rows[node[1]]
        if kind == "all":
            return arrays.all_words
        if kind == "zero":
            return kernels.zero_bitmap(arrays.n_words, arrays.device)
        if kind == "and":
            _, pos, negs = node
            acc = self._combine(arrays, pos[0], rows) if pos else arrays.all_words
            for s in pos[1:]:
                acc = acc & self._combine(arrays, s, rows)
            for s in negs:
                acc = acc & ~self._combine(arrays, s, rows)
            return acc
        if kind == "or":
            acc = kernels.zero_bitmap(arrays.n_words, arrays.device)
            for s in node[1]:
                acc = acc | self._combine(arrays, s, rows)
            return acc
        return arrays.all_words & ~self._combine(arrays, node[1], rows)  # "not"

    def _regexp_spans(self, arrays: DeviceArrays, q: RegexpQuery, gis: dict,
                      classes: dict, note: dict):
        """The postings spans of a regexp leaf: its K1 matches, the narrowed
        range of a prefix, or the host walk's matches of a general
        pattern."""
        kind, _val = classes[id(q)]
        if kind in ("literal", "alternation"):
            return kernels.term_spans(arrays.host_post_idx, gis[id(q)])
        start, count, _, _ = arrays.fields.get(q.field, (0, 0, 0, 0))
        if not count:
            return []
        lo, hi = self._prefix_range(arrays, q.pattern, start, count)
        if kind == "prefix" and not arrays.dot_safe:
            kind = "general"  # a \n-bearing term breaks range == match
        if kind == "prefix":
            # the narrowed range IS the match: every term in it carries
            # the literal prefix and `.*` accepts any suffix
            if hi <= lo:
                return []
            return [(int(arrays.host_post_idx[lo, 0]), int(arrays.host_post_idx[hi - 1, 1]))]
        # general pattern: the automaton walk stays on the host over the
        # narrowed candidate range (routing reason regexp-host-fallback);
        # the postings union runs on the card
        note["host_regexp"] = True
        rx = re.compile(b"^(?:" + q.pattern + b")$")
        matched = [
            gi for gi in range(lo, hi) if rx.match(self._host_term(arrays, gi))
        ]
        return kernels.term_spans(arrays.host_post_idx, matched)

    def _prefix_range(self, arrays: DeviceArrays, pattern: bytes,
                      start: int, count: int) -> tuple[int, int]:
        """[lo, hi) global candidate range from the literal prefix —
        host binary search over the key-matrix mirror (segment.py's
        prefix-prune, shared compare definition in kernels.py)."""
        lo, hi = start, start + count
        pre = literal_prefix(pattern)
        if not pre:
            return lo, hi
        width = 4 * arrays.k_words
        if len(pre) > width:
            # every term is <= width bytes: nothing can carry this prefix
            return start, start
        pk, pl = kernels.build_term_keys([pre], arrays.k_words)
        lo = kernels.host_lower_bound(
            arrays.host_keys, arrays.host_lens, lo, hi, pk[0], int(pl[0])
        )
        up = prefix_upper(pre)
        if up is not None and len(up) <= width:
            uk, ul = kernels.build_term_keys([up], arrays.k_words)
            hi = kernels.host_lower_bound(
                arrays.host_keys, arrays.host_lens, lo, hi, uk[0], int(ul[0])
            )
        return lo, hi

    def _host_term(self, arrays: DeviceArrays, gi: int) -> bytes:
        """Term bytes for a global index, read from the HOST segment
        (DiskSegment addresses globally; SealedSegment via its per-field
        sorted list). ``arrays`` is the caller's snapshot — re-reading
        self._arrays here would race a concurrent eviction."""
        host = self.host
        term = getattr(host, "_term", None)
        if term is not None:  # DiskSegment: zero-copy global lookup
            return term(gi)
        for name in sorted(arrays.fields):
            start, count = arrays.fields[name][:2]
            if start <= gi < start + count:
                return host.terms(name)[gi - start]
        raise IndexError(gi)
