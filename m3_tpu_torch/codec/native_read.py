"""Array reads of M3TSZ streams on the host.

Port of ``m3_tpu/codec/native_read.py``. Segments decode in one host
codec library call (``native.decode_batch``, the points of
``codec/m3tsz.decode``) and merge per segment: newest segment wins per
timestamp, and within one segment the last of equal timestamps wins
(``merge_segment_arrays``). Annotated streams (flagged by the library)
return None here and go to the annotation-capable
``codec/iterator.MultiReaderIterator``, as in the reference.

The reference's pure-Python fallback, which it takes only without its
library, differs on one edge: its uncached reads go through
``MultiReaderIterator``, which keeps the FIRST of equal timestamps within
one segment (sub-second times that truncate to one time under unit
SECOND). The port has no such fallback (ROADMAP §C).
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..utils.xtime import Unit
from .m3tsz import Datapoint


def merge_segment_arrays(triples):
    """Merge per-segment (times, values, units) arrays, newest-segment-wins
    per timestamp (MultiReaderIterator's heap dedupe, vectorized).
    ``triples`` are oldest-first."""
    live = [t for t in triples if len(t[0])]
    if not live:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.float64),
            np.zeros(0, np.uint8),
        )
    if len(live) == 1:
        return live[0]
    t_all = np.concatenate([t for t, _, _ in live])
    v_all = np.concatenate([v for _, v, _ in live])
    u_all = np.concatenate([u for _, _, u in live])
    order = np.argsort(t_all, kind="stable")  # equal t: concat order kept
    ts = t_all[order]
    keep = np.empty(len(ts), bool)
    keep[:-1] = ts[1:] != ts[:-1]
    keep[-1] = True  # last of each equal-t run = newest segment
    idx = order[keep]
    return t_all[idx], v_all[idx], u_all[idx]


def decode_stream_arrays(stream: bytes):
    """Decode ONE m3tsz stream → (times, values, units) arrays, or None
    when the stream carries annotations (the decoded-block cache stores
    plain arrays; annotated streams fall back to the Datapoint iterator so
    Datapoint.annotation survives)."""
    if not stream:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.float64),
            np.zeros(0, np.uint8),
        )
    triples, flags = native.decode_batch([stream], with_flags=True)
    if flags[0]:
        return None
    return triples[0]


def read_segments_arrays(segments, start=None, end=None):
    """Decode + merge segments into (times, values, units) arrays, or None
    when any segment carries annotations (the caller falls back to the
    annotation-capable iterator) or there is nothing to decode."""
    segs = [s for s in segments if s]
    if not segs:
        return None
    triples, flags = native.decode_batch(segs, with_flags=True)
    if flags.any():
        return None
    t, v, u = merge_segment_arrays(triples)
    if start is not None:
        lo = int(np.searchsorted(t, start, side="left"))
        hi = int(np.searchsorted(t, end, side="left"))
        t, v, u = t[lo:hi], v[lo:hi], u[lo:hi]
    return t, v, u


def read_segments(segments, start=None, end=None):
    """list[Datapoint] through the array route; None → caller falls back."""
    arrs = read_segments_arrays(segments, start, end)
    if arrs is None:
        return None
    t, v, u = arrs
    return [
        Datapoint(int(tt), float(vv), Unit(int(uu)))
        for tt, vv, uu in zip(t, v, u)
    ]
