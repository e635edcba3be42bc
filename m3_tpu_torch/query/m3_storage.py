"""Storage adapter: matchers → index query → matched series decoded onto
the step grid.

The port's stand-in for ``m3_tpu/query/m3_storage.py`` ``M3Storage``
(its ``matchers_to_index_query``, ``fetch_grid`` and ``_stitch_grid_rows``),
over ONE sealed block held on the card. Matchers resolve through the
port's inverted index (``index/``): the block's series are the docs of one
sealed index segment, resident in a ``DeviceIndexStore``, searched by the
index kernels K1 and K2. The Database and residency wiring are a later
slice (ROADMAP.md §A3); ``BlockStorage`` is what it replaces.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..block.core import SeriesMeta, Tags
from ..codec.m3tsz import decode
from ..index.device import DeviceIndexStore
from ..index.ns_index import NamespaceIndex
from ..index.query import AllQuery, conj, neg, regexp, search_segment, term
from ..ops import chunked, fused
from ..utils.serialize import encode_tags
from .engine import consolidate_row
from .plan import consolidate_grid
from .promql import Matcher

# one index block spans every sample time a BlockStorage holds
_BLOCK_NANOS = 1 << 62


def matchers_to_index_query(matchers: list[Matcher]):
    """models.Matchers → idx.Query (storage/index/convert). A copy of
    ``m3_tpu/query/m3_storage.py:30``: a missing tag matches no term, so
    ``{missing=""}`` matches no series and ``{missing!=""}`` all of them."""
    qs = []
    for m in matchers:
        name = m.name.encode()
        value = m.value.encode()
        if m.op == "=":
            qs.append(term(name, value))
        elif m.op == "!=":
            qs.append(neg(term(name, value)))
        elif m.op == "=~":
            qs.append(regexp(name, value))
        elif m.op == "!~":
            qs.append(neg(regexp(name, value)))
        else:
            raise ValueError(f"bad matcher op {m.op}")
    if not qs:
        return AllQuery()
    if len(qs) == 1:
        return qs[0]
    return conj(*qs)


class BlockStorage:
    """One sealed block: series tags on the host, their M3TSZ chunk-lanes
    packed series-major on the device.

    Series i is ``streams[i % len(streams)]`` with tags ``tags[i]``; more
    tags than streams tile the streams on the device (``pack_lanes
    n_series=``), so the host holds only the unique streams. Series i is
    also doc i of the block's index segment (its id the encoded tags, so
    two series may not share a tag set), admitted at construction into a
    ``DeviceIndexStore`` on the same device."""

    def __init__(self, streams: list[bytes], tags: list[Tags], k: int = 24, device="cuda"):
        if not streams or len(tags) < len(streams):
            raise ValueError("want at least one stream and a tag set per series")
        self.device = resolve_device(device)
        self.streams = list(streams)
        self.k = k
        self.metas = [SeriesMeta(tags=t) for t in tags]
        batch = chunked.build_chunked(self.streams, k=k)
        self.num_chunks = batch.num_chunks
        self.packed = fused.pack_lanes(
            batch, order="s", device=self.device, n_series=len(tags)
        )
        self.index_store = DeviceIndexStore(device=self.device)
        self.index = NamespaceIndex(_BLOCK_NANOS, device_store=self.index_store)
        self.index.write_batch([(encode_tags(t), t, 0) for t in tags])
        if len(self.index.blocks[0].mutable) != len(tags):
            raise ValueError("two series share a tag set")
        self.index.seal_before(_BLOCK_NANOS)

    def match(self, matchers: list[Matcher]) -> np.ndarray:
        """Indices of the series whose tags satisfy every matcher (=, !=,
        =~, !~ with full-match regexps), ascending: the postings of
        ``matchers_to_index_query(matchers)`` over the block's index
        segment (on the device tier while it is resident)."""
        (seg,) = self.index.blocks[0].sealed
        q = matchers_to_index_query(matchers)
        return search_segment(seg, q, cache=self.index.postings_cache).astype(np.int64)

    def fetch_grid(self, matchers, start_nanos, end_nanos, grid, lookback_nanos):
        """Matched series consolidated onto ``grid`` (int64 step times)
        with samples in ``[start_nanos, end_nanos)``: gather their lanes on
        the device, decode (kernel R), consolidate, and re-read on the host
        the rows the device decoder bailed on (err). Returns (metas,
        values float64[S, T] on the device, datapoints)."""
        sel = self.match(matchers)
        c = self.num_chunks
        lanes = (torch.from_numpy(sel).to(self.device)[:, None] * c
                 + torch.arange(c, device=self.device)[None, :]).reshape(-1)
        res = chunked.decode_chunked(
            self.packed.windows[:, lanes], self.packed.lanes[:, lanes], s=sel.size, c=c, k=self.k
        )
        values, datapoints = consolidate_grid(res, start_nanos, end_nanos, grid, lookback_nanos)
        err_rows = torch.nonzero(res.err).flatten().tolist()
        for i in err_rows:
            dps = [dp for dp in decode(self.streams[int(sel[i]) % len(self.streams)])
                   if start_nanos <= dp.timestamp < end_nanos]
            row = consolidate_row(
                np.asarray([dp.timestamp for dp in dps], np.int64),
                np.asarray([dp.value for dp in dps], np.float64),
                np.asarray(grid, np.int64), lookback_nanos,
            )
            values[i] = torch.from_numpy(row).to(values.device)
        return [self.metas[i] for i in sel], values, datapoints
