"""Cross-segment batched leaf match: ONE K1 launch per query.

Port of ``m3_tpu/index/device/batch.py``. The per-segment device executor
(segment.py) already batches every exact-match leaf of a query AST into one
K1 launch, but a namespace holding several device-resident segments
(several index blocks in range) would pay one launch and one device read
per segment. Here ALL of a query's exact leaves resolve over ALL
device-resident segments in one launch:

- the segments' fixed-width term-key matrices concatenate into one
  matrix, each padded to the widest segment's key width (trailing zero
  words preserve the (words, length) order within a segment, and every
  search row's [lo, hi) bounds stay inside one segment's field range);
- query rows are laid out (segment-major) × (leaf), with per-row bounds
  offset by the segment's base; a value wider than ITS segment's key
  width is marked unmatchable for that segment only;
- results map back per segment by subtracting the base.

The concatenated matrix is cached per segment-identity tuple (a tiny
bounded map holding WEAK references to its sources — identity changes on
admission/eviction invalidate entries without pinning evicted tiers). The
concatenated copy itself is device memory OUTSIDE the index store's byte
budget, bounded by the cache cap × the term dictionaries of one segment
set.

Where the port differs from the reference: the reference's batcher is
best-effort and turns any exception into None (per-segment launches then
answer; ``m3_tpu/index/device/batch.py:171-173``). Here a failed build or
launch raises; None means only that batching does not apply (a segment's
tier was evicted under the query).
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from ...utils.instrument import DEFAULT as METRICS
from . import kernels
from .segment import collect_leaves, match_rows

_M_BATCHED = METRICS.counter(
    "index_batched_match_total",
    "cross-segment batched leaf-match launches (one per query touching "
    ">1 device-resident segment; replaces one launch per segment)",
)

_CACHE_CAP = 4
_combined_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def _combined(arrays_list):
    """Concatenated (keys, lens, bases, k_max) for a segment-arrays tuple,
    cached by identity. Identity is held via WEAK references: a plain
    id()-keyed entry whose sources were garbage-collected could alias a
    recycled address onto different segments and serve a stale term
    matrix, while strong references would pin evicted index tiers (device
    bytes the store's budget thinks are free). A dead or mismatched
    weakref simply rebuilds the bundle."""
    key = tuple(id(a) for a in arrays_list)
    hit = _combined_cache.get(key)
    if hit is not None and all(ref() is a for ref, a in zip(hit[4], arrays_list)):
        _combined_cache.move_to_end(key)
        return hit[:4]
    k_max = max(a.k_words for a in arrays_list)
    mats = []
    bases = [0]
    for a in arrays_list:
        mats.append(torch.nn.functional.pad(a.term_keys, (0, k_max - a.k_words)))
        bases.append(bases[-1] + a.n_terms)
    out = (
        torch.cat(mats, dim=0),
        torch.cat([a.term_lens for a in arrays_list], dim=0),
        np.asarray(bases, np.int64),
        k_max,
    )
    _combined_cache[key] = out + (tuple(weakref.ref(a) for a in arrays_list),)
    while len(_combined_cache) > _CACHE_CAP:
        _combined_cache.popitem(last=False)
    return out


def prematch(device_segs, query) -> dict | None:
    """Resolve every exact-match leaf of ``query`` over every segment in
    ``device_segs`` with ONE K1 launch.

    Returns ``{id(seg): (arrays, gis_map, classes)}`` suitable for
    ``DeviceSegment.search_ast(query, prematched=...)`` — each entry
    pinned to the arrays snapshot it was computed against — or None when
    a segment's tier was evicted under the query (each segment then runs
    its own match)."""
    snaps = []
    for seg in device_segs:
        arrays = getattr(seg, "_arrays", None)
        if arrays is None:
            return None
        snaps.append((seg, arrays))
    leaves, order, classes = collect_leaves(query)
    if not leaves:
        # nothing to batch; hand every segment its (empty) result so
        # per-segment searches skip their own empty launch too
        return {id(seg): (arrays, {}, dict(classes)) for seg, arrays in snaps}
    keys, lens, bases, k_max = _combined([a for _, a in snaps])
    b = len(leaves)
    rows = len(snaps) * b
    values: list[bytes] = []
    lo = np.zeros(rows, np.int32)
    hi = np.zeros(rows, np.int32)
    for s, (_seg, a) in enumerate(snaps):
        base = int(bases[s])
        width = 4 * a.k_words
        for i, (field, value) in enumerate(leaves):
            row = s * b + i
            start, count = a.fields.get(field, (0, 0, 0, 0))[:2]
            # wider than THIS segment's keys: unmatchable there even though
            # the padded width could hold the bytes (an empty range)
            if len(value) > width:
                count = 0
            lo[row], hi[row] = base + start, base + start + count
            values.append(value)
    with kernels.PROFILER.dispatch(("match", (rows, k_max))) as d:
        gis = d.done(match_rows(keys, lens, lo, hi, values, k_max, keys.device))
    _M_BATCHED.inc()
    out: dict = {}
    for s, (seg, a) in enumerate(snaps):
        base = int(bases[s])
        seg_gis = gis[s * b : s * b + b].copy()
        seg_gis[seg_gis >= 0] -= base
        gis_map = {id(leaf): seg_gis[start : start + n] for leaf, start, n in order}
        out[id(seg)] = (a, gis_map, dict(classes))
    return out
