"""The reference's encoding iterator stack, host side.

A copy of ``m3_tpu/codec/iterator.py`` over the port's ``codec/m3tsz.py``.

Reference: M3's src/dbnode/encoding/types.go:40-310 —
``ReaderIterator`` walks one encoded segment (codec/m3tsz.py here),
``MultiReaderIterator`` merges the segments of ONE replica in time order
(multi_reader_iterator.go), ``SeriesIterator`` merges replicas and dedupes
duplicate timestamps (series_iterator.go), and ``SeriesIterators`` batches
them. The port decodes the hot aggregate path on the card
(ops/fused.py); this stack is the exact-semantics host path used by the
client session's replica merge, the storage read path, and anything that
needs annotations (which the device decoder does not surface).

Merge semantics:
- within one replica, callers pass segments oldest-first (flushed fileset
  blocks, then in-memory buffer blocks); on a duplicate timestamp the
  LATEST segment wins — matching the buffer-over-fileset precedence of
  dbShard.ReadEncoded (shard.go:1060).
- across replicas, the FIRST replica to produce a timestamp wins —
  series_iterator.go's first-wins dedupe (iterators.go:less).
"""

from __future__ import annotations

import heapq
from typing import Iterable, Iterator

from .m3tsz import Datapoint, ReaderIterator


class MultiReaderIterator:
    """Time-ordered merge of one replica's segments (multi_reader_iterator.go).

    ``segments`` are encoded m3tsz streams, oldest-first; empty segments are
    skipped. Exposes the same next()/current() surface as ReaderIterator.
    """

    def __init__(self, segments: Iterable[bytes], **reader_kwargs) -> None:
        self._heap: list[tuple[int, int, Datapoint, ReaderIterator]] = []
        self._current: Datapoint | None = None
        self.err: Exception | None = None
        for prio, seg in enumerate(segments):
            if not seg:
                continue
            it = ReaderIterator(seg, **reader_kwargs)
            self._push(prio, it)

    def _push(self, prio: int, it: ReaderIterator) -> None:
        if it.next():
            dp = it.current()
            # heap orders by (timestamp, -priority): among equal timestamps
            # the highest-priority (newest) segment surfaces first
            heapq.heappush(self._heap, (dp.timestamp, -prio, dp, it))
        elif it.err is not None and not isinstance(it.err, EOFError):
            # EOF is stream end; anything else is real corruption and must
            # surface, not silently truncate the merge (decode() parity)
            self.err = self.err or it.err

    def next(self) -> bool:
        if self.err is not None:
            raise self.err
        if not self._heap:
            self._current = None
            return False
        t, neg_prio, dp, it = heapq.heappop(self._heap)
        self._push(-neg_prio, it)
        # drop older-segment duplicates of the same timestamp
        while self._heap and self._heap[0][0] == t:
            _, np2, _, it2 = heapq.heappop(self._heap)
            self._push(-np2, it2)
        self._current = dp
        return True

    def current(self) -> Datapoint:
        assert self._current is not None
        return self._current

    def __iter__(self) -> Iterator[Datapoint]:
        while self.next():
            yield self.current()


class SeriesIterator:
    """Replica merge for one series (series_iterator.go).

    ``replicas`` are per-replica MultiReaderIterators (or anything with the
    next()/current() surface). Points outside [start, end) are filtered when
    bounds are given. First replica wins on duplicate timestamps.
    """

    def __init__(
        self,
        series_id: bytes,
        replicas: Iterable[MultiReaderIterator],
        start_nanos: int | None = None,
        end_nanos: int | None = None,
        tags: tuple | None = None,
    ) -> None:
        self.id = series_id
        self.tags = tags
        self.start = start_nanos
        self.end = end_nanos
        self.err: Exception | None = None
        self._heap: list[tuple[int, int, Datapoint, MultiReaderIterator]] = []
        self._current: Datapoint | None = None
        for prio, rep in enumerate(replicas):
            self._push(prio, rep)

    def _push(self, prio: int, rep: MultiReaderIterator) -> None:
        while rep.next():
            dp = rep.current()
            if self.start is not None and dp.timestamp < self.start:
                continue
            if self.end is not None and dp.timestamp >= self.end:
                return
            # equal timestamps: LOWEST replica index first -> first wins
            heapq.heappush(self._heap, (dp.timestamp, prio, dp, rep))
            return
        err = getattr(rep, "err", None)
        if err is not None and self.err is None:
            self.err = err

    def next(self) -> bool:
        if self.err is not None:
            raise self.err
        if not self._heap:
            self._current = None
            return False
        t, prio, dp, rep = heapq.heappop(self._heap)
        self._push(prio, rep)
        while self._heap and self._heap[0][0] == t:
            _, p2, _, rep2 = heapq.heappop(self._heap)
            self._push(p2, rep2)
        self._current = dp
        return True

    def current(self) -> Datapoint:
        assert self._current is not None
        return self._current

    def __iter__(self) -> Iterator[Datapoint]:
        while self.next():
            yield self.current()


class SeriesIterators:
    """Batch of SeriesIterators (encoding/types.go SeriesIterators)."""

    def __init__(self, iters: list[SeriesIterator]) -> None:
        self.iters = iters

    def __len__(self) -> int:
        return len(self.iters)

    def __iter__(self) -> Iterator[SeriesIterator]:
        return iter(self.iters)

    def __getitem__(self, i: int) -> SeriesIterator:
        return self.iters[i]
