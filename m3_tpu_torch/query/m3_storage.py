"""Storage adapter: matchers → matched series decoded onto the step grid.

The port's stand-in for ``m3_tpu/query/m3_storage.py`` ``M3Storage``
(its ``fetch_grid`` and ``_stitch_grid_rows``), over ONE sealed block held
on the card. The Database, the index and residency wiring are later slices
(ROADMAP.md §A.2 and §A.4); ``BlockStorage`` is what they replace.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .. import resolve_device
from ..block.core import SeriesMeta, Tags
from ..codec.m3tsz import decode
from ..ops import chunked, fused
from .engine import consolidate_row
from .plan import consolidate_grid
from .promql import Matcher


class BlockStorage:
    """One sealed block: series tags on the host, their M3TSZ chunk-lanes
    packed series-major on the device.

    Series i is ``streams[i % len(streams)]`` with tags ``tags[i]``; more
    tags than streams tile the streams on the device (``pack_lanes
    n_series=``), so the host holds only the unique streams."""

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
        # per tag name: the distinct values (b"" for a series without the
        # tag) and each series' code into them
        names = sorted({name for t in tags for name, _ in t})
        self._columns = {}
        for name in names:
            col = [dict(t).get(name, b"") for t in tags]
            uniq, codes = np.unique(np.asarray(col, dtype=object), return_inverse=True)
            self._columns[name.decode()] = ([u.decode() for u in uniq], codes)

    def match(self, matchers: list[Matcher]) -> np.ndarray:
        """Indices of the series whose tags satisfy every matcher (=, !=,
        =~, !~ with full-match regexps; a missing tag reads as "")."""
        ok = np.ones(len(self.metas), bool)
        for m in matchers:
            uniq, codes = self._columns.get(m.name, ([""], np.zeros(len(self.metas), np.int64)))
            if m.op in ("=", "!="):
                hit = np.asarray([u == m.value for u in uniq], bool)
            elif m.op in ("=~", "!~"):
                pat = re.compile(m.value)
                hit = np.asarray([pat.fullmatch(u) is not None for u in uniq], bool)
            else:
                raise ValueError(f"bad matcher op {m.op}")
            if m.op in ("!=", "!~"):
                hit = ~hit
            ok &= hit[codes]
        return np.nonzero(ok)[0]

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
