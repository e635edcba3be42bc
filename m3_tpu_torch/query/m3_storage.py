"""Storage adapters: matchers → index query → matched series.

Port of ``m3_tpu/query/m3_storage.py``:

- ``M3Storage`` — the Engine's storage over one ``storage.Database``
  namespace. ``fetch_grid`` serves an eligible range-query fetch through the
  one-program query plan (``query/plan.py`` ``Planner``: the index match,
  the resident assembly B-2, the records decode R and the consolidation B-1
  on the device, one readback), and returns None for the rest, which the
  engine serves staged: ``fetch`` (raw samples of the matched series) and
  ``scan_totals`` (whole-block scan-and-aggregate), each routed either to
  decode-from-residency (``resident/scan``: kernel R for fetches, B1 for
  scans, both over the resident lane assembly B-2) or to the streamed path
  (fileset streams decoded on the host for fetches, uploaded and decoded by
  B1 for scans), with read-through re-admission of evicted blocks. The
  routes that are the reference's semantics stay and are recorded in
  ``query/stats`` routing records: a plan-ineligible query runs staged
  with the plan's reason (``plan:<reason>``), a block that is not resident
  streams, a raced eviction streams, annotated lanes re-read on the host, a
  budget-deferred re-admission is skipped.

  Two divergences, on purpose (ROADMAP §C):
  - the reference's ``fetch_grid`` catches every exception from the plan
    and serves the query staged as ``plan:device-error``. Here an
    ``Ineligible`` stays a recorded route (the ``force-staged`` and
    ``plan-disabled`` bypasses count no fallback, as in the reference), but
    any other exception from the plan (a failed build or launch, a CUDA
    error, an OOM) is counted in ``query_plan_errors_total`` and RAISED;
  - the reference's ``_maybe_readmit`` catches every exception so that the
    query, already served from the streamed result, succeeds. Here only the
    pool's own budget refusal is a counted, quiet outcome; a failed build, a
    failed launch or any CUDA error (OOM included) during re-admission is
    counted in ``resident_readmission_failures_total`` and RAISED.
  Either way a device fault is never hidden behind a host answer.
- ``BlockStorage`` — ONE sealed block held on the card, with
  ``fetch_grid`` (the device gather, kernel R, kernel B-1). ``chip_smoke.py``
  holds ``M3Storage`` to it; its retirement is queued in ROADMAP §B's list
  of speed work. Its matchers resolve through the port's inverted index
  (``index/``): the block's series are the docs of one sealed index
  segment, resident in a ``DeviceIndexStore``, searched by the index
  kernels K1 and K2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..block.core import SeriesMeta, Tags
from ..codec.iterator import MultiReaderIterator
from ..codec.m3tsz import decode
from ..codec.native_read import read_segments_arrays
from ..index.device import DeviceIndexStore
from ..index.ns_index import NamespaceIndex
from ..index.query import AllQuery, conj, neg, regexp, search_segment, term
from ..ops import chunked, fused
from ..parallel.scan import stitch_host_errors
from ..resident.scan import resident_fetch_arrays, resident_scan_totals, streamed_scan_totals
from ..storage.database import Database
from ..storage.fs import CHUNK_K, FilesetID
from ..utils.instrument import DEFAULT as METRICS
from ..utils.serialize import encode_tags
from ..utils.trace import NOOP_SPAN, TRACER
from . import stats
from .engine import consolidate_row
from .plan import consolidate_grid
from .promql import Matcher

# one index block spans every sample time a BlockStorage holds
_BLOCK_NANOS = 1 << 62

# read-through re-admissions that failed; in the port a failure also raises
_M_READMIT_FAILURES = METRICS.counter(
    "resident_readmission_failures_total",
    "read-through re-admissions that failed (the port raises them: a device "
    "fault is not hidden behind the streamed result)",
)


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


class _EmptyTotals:
    """ScanAggregates stand-in for a scan that matched no lanes."""

    total_sum = 0.0
    total_count = 0
    total_min = float("nan")
    total_max = float("nan")


_EMPTY_TOTALS = _EmptyTotals()


@dataclass
class M3Storage:
    """Engine Storage over one Database namespace: ``fetch_grid`` through
    the query plan, else the staged ``fetch`` (the engine consolidates on
    the host)."""

    db: Database
    namespace: str

    @property
    def planner(self):
        """The device query planner (``query/plan.py``), one per adapter,
        owning the LRU plan cache for this namespace."""
        p = self.__dict__.get("_planner")
        if p is None:
            from .plan import Planner

            p = self.__dict__["_planner"] = Planner(self.db, self.namespace)
        return p

    def fetch_grid(self, matchers, start_nanos, end_nanos, grid, lookback_nanos):
        """The fetch and its consolidation onto the engine's step grid as
        one plan execution (``query/plan.py``): the matchers resolve, the
        lanes decode and consolidate on the device, with one readback; the
        host attaches tags. Returns ``(metas, values f64[S, T] on the
        pool's device, datapoints)``, or None to run the staged path: every
        ineligibility cause lands in the routing record. A fault of the
        plan's device work raises (the module docstring).

        ``grid`` is the engine's consolidation timestamp vector (i64
        nanos); ``[start_nanos, end_nanos)`` the raw fetch window
        (lookback included by the caller)."""
        from .plan import _M_ERRORS, _M_FALLBACKS, Ineligible

        try:
            matched, values, datapoints, err_rows = self.planner.run(
                matchers, start_nanos, end_nanos, grid, lookback_nanos
            )
        except Ineligible as e:
            stats.add_routing(b"*", None, "staged", f"plan:{e.reason}")
            if e.reason in ("force-staged", "plan-disabled"):
                # deliberate bypasses (the parity probe, the kill switch)
                # are not degradations: they must not count as fallbacks
                return None
            self.planner.fallbacks += 1
            _M_FALLBACKS.inc()
            stats.add(plan_fallbacks=1)
            # release plans stamped against state that has since moved
            self.planner.evict_stale()
            return None
        except Exception:
            _M_ERRORS.inc()
            raise
        matched, metas = matched
        if len(err_rows):
            # lanes the device decoder bailed on (annotated streams):
            # batched host re-read per block, consolidated with the same
            # rule; the routing record shows the hybrid per series
            values = self._stitch_grid_rows(
                matched, err_rows, values, start_nanos, end_nanos, grid, lookback_nanos,
            )
        st = stats.current()
        if st is not None and st.record_routing:
            err_set = set(int(i) for i in err_rows)
            for i, doc in enumerate(matched):
                stats.add_routing(
                    doc.id, None, "fused",
                    "annotated-err-lane (host stitch)" if i in err_set else "device-plan",
                )
        nb = int(values.numel()) * 16  # times+values equivalent of the staged read
        stats.add(resident_hits=1, bytes_=nb, resident_bytes=nb)
        return metas, values, datapoints

    def _stitch_grid_rows(self, matched, err_rows, values, start_nanos, end_nanos, grid,
                          lookback_nanos):
        """Host-consolidate the err rows from batched codec re-reads,
        through the ONE shared 'last' consolidation rule
        (engine.consolidate_row), so the hybrid rows cannot drift from the
        staged path's."""
        err_docs = [matched[int(i)] for i in err_rows]
        arrays = self.host_stitch_arrays(err_docs, start_nanos, end_nanos)
        values = values.clone()
        for i, doc in zip(err_rows, err_docs):
            t, v = arrays[doc.id]
            row = consolidate_row(t, v, np.asarray(grid, np.int64), lookback_nanos)
            values[int(i)] = torch.from_numpy(row).to(values.device)
        return values

    def host_stitch_arrays(self, docs, start_nanos, end_nanos) -> dict:
        """Batched host-codec re-read for lanes the device decoder bailed
        on: ``doc.id -> (times i64, values f64)`` sliced to [start, end).

        Streams are collected with ONE FilesetReader pass per fileset —
        grouped by block, not one series at a time — then decoded as
        ``Shard.read_arrays`` decodes them; callers use this only where no buffer
        overlays the range (the residency gate excludes overlays), so
        fileset streams are the whole truth."""
        ns = self.db.namespaces[self.namespace]
        bsz = ns.opts.block_size_nanos
        per_series: dict[bytes, list] = {}
        by_shard: dict[int, list] = {}
        for doc in docs:
            per_series[doc.id] = []
            by_shard.setdefault(ns.shard_for(doc.id).id, []).append(doc.id)
        for shard_id, sids in by_shard.items():
            shard = ns.shards[shard_id]
            # fileset order mirrors Shard._segments_locked (oldest-first
            # listing order) so per-series segment order — and therefore
            # decoded output — is identical to read_arrays
            for fid in shard.filesets():
                if (
                    fid.block_start + bsz <= start_nanos
                    or fid.block_start >= end_nanos
                ):
                    continue
                reader = shard.reader_or_none(FilesetID(
                    self.namespace, shard_id, fid.block_start, fid.volume
                ))
                if reader is None:
                    continue  # retention race or quarantined mid-query
                for sid in sids:
                    stream = reader.stream(sid)
                    if stream:
                        per_series[sid].append(stream)
        out = {}
        for doc in docs:
            segs = per_series[doc.id]
            arrs = read_segments_arrays(segs, start_nanos, end_nanos)
            if arrs is not None:
                out[doc.id] = (
                    np.asarray(arrs[0], np.int64),
                    np.asarray(arrs[1], np.float64),
                )
                continue
            dps = [
                dp
                for dp in MultiReaderIterator(segs)
                if start_nanos <= dp.timestamp < end_nanos
            ]
            out[doc.id] = (
                np.asarray([dp.timestamp for dp in dps], np.int64),
                np.asarray([dp.value for dp in dps], np.float64),
            )
        return out

    def fetch(self, matchers, start_nanos, end_nanos):
        """[(tags, times i64, values f64)] of the series matching
        ``matchers`` with samples in [start, end): decode-from-residency
        when every matched block is resident and no live buffer overlays
        the range, else the streamed array reads (with read-through
        re-admission). The index resolves ONCE for both."""
        q = matchers_to_index_query(matchers)
        cache = getattr(self.db, "block_cache", None)
        before = cache.stats() if cache is not None else None
        pool = getattr(self.db, "resident_pool", None)
        rows = None
        if pool is None or not pool.enabled:
            stats.add_routing(b"*", None, "streamed", "resident pool disabled")
        elif len(pool) == 0:
            stats.add_routing(b"*", None, "streamed", "resident pool empty")
        if pool is not None and pool.enabled:
            # an EMPTY pool still takes this branch: the streamed fallback
            # below re-admits sealed complete blocks (read-through)
            docs = self.db.query_ids(
                self.namespace, q, start_nanos, end_nanos
            ).docs
            resident = self._fetch_resident(docs, start_nanos, end_nanos)
            if resident is not None:
                nb = sum(t.nbytes + v.nbytes for _, t, v in resident)
                stats.add(resident_hits=1, bytes_=nb, resident_bytes=nb)
                return resident
            rows = self.db.fetch_tagged_arrays(
                self.namespace, q, start_nanos, end_nanos, docs=docs
            )
            self._maybe_readmit(docs, start_nanos, end_nanos)
        if pool is not None:
            stats.add(resident_misses=1)
        out = []
        total_bytes = 0
        if rows is None:
            rows = self.db.fetch_tagged_arrays(
                self.namespace, q, start_nanos, end_nanos
            )
        for sid, tags, (times, vals) in rows:
            times = np.asarray(times, np.int64)
            vals = np.asarray(vals, np.float64)
            total_bytes += times.nbytes + vals.nbytes
            out.append((tags, times, vals))
        if before is not None:
            after = cache.stats()
            stats.add(
                bytes_=total_bytes,
                cache_hits=after["hits"] - before["hits"],
                cache_misses=after["misses"] - before["misses"],
            )
        else:
            stats.add(bytes_=total_bytes)
        return out

    # ---------- residency routing ----------

    def _resident_plan(self, docs, start_nanos, end_nanos):
        """(doc, resident BlockKeys) per matched doc when the query is
        fully servable from the pool, else None. A series is servable when
        every overlapping fileset block is either resident or
        complete-admitted with the series absent, and no buffered data
        overlaps the range."""
        pool = getattr(self.db, "resident_pool", None)
        if pool is None or not pool.enabled:
            return None
        ns = self.db.namespaces[self.namespace]
        plan = []
        for doc in docs:
            shard = ns.shard_for(doc.id)
            keys, buffered = shard.scan_block_keys(doc.id, start_nanos, end_nanos)
            if buffered:
                # only the cause and the final outcome are recorded
                stats.add_routing(doc.id, None, "streamed", "buffered-overlay")
                pool.heat.charge(shard.id, misses=1)
                return None
            doc_keys = []
            for key in keys:
                if key in pool:
                    doc_keys.append(key)
                elif pool.is_complete(
                    key.namespace, key.shard_id, key.block_start, key.volume
                ):
                    continue  # fileset fully admitted: series absent from it
                else:
                    stats.add_routing(
                        doc.id, key.block_start, "streamed",
                        "not-resident (evicted or never admitted)",
                    )
                    pool.heat.charge(key.shard_id, misses=1)
                    return None  # evicted / never admitted: stream instead
            plan.append((doc, doc_keys))
        # routing + hit heat are recorded by _record_resident_routing once
        # the resident scan has succeeded
        return plan

    def _record_resident_routing(self, plan) -> None:
        """Routing records + per-shard heat for a resident scan that
        succeeded, charged once per shard."""
        pool = self.db.resident_pool
        lanes_per_shard: dict[int, int] = {}
        for doc, doc_keys in plan:
            for key in doc_keys:
                stats.add_routing(doc.id, key.block_start, "resident",
                                  "resident-chunked")
                lanes_per_shard[key.shard_id] = (
                    lanes_per_shard.get(key.shard_id, 0) + 1
                )
        for shard_id, lanes in lanes_per_shard.items():
            pool.heat.charge(shard_id, hits=lanes)

    def _maybe_readmit(self, docs, start_nanos, end_nanos) -> int:
        """Read-through re-admission: when a query fell back to the
        streamed path because sealed, complete blocks were NOT resident
        (evicted, or sealed by a previous process past the bootstrap
        budget), pull exactly those filesets back into the pool, budget
        permitting (free space only: re-admissions never evict). Buffered
        series are skipped; filesets that can never complete or whose
        last re-admission the budget refused are skipped too. Counted in
        resident_readmissions_total. A failure raises (see the module
        docstring)."""
        pool = getattr(self.db, "resident_pool", None)
        if pool is None or not pool.enabled:
            return 0
        if not pool.has_free_capacity():
            # a full pool can't take anything: skip the block walk AND the
            # fileset disk re-reads
            return 0
        ns = self.db.namespaces[self.namespace]
        todo: dict[tuple, object] = {}
        for doc in docs:
            shard = ns.shard_for(doc.id)
            keys, buffered = shard.scan_block_keys(doc.id, start_nanos, end_nanos)
            if buffered:
                continue
            for key in keys:
                group = (key.namespace, key.shard_id, key.block_start, key.volume)
                if key in pool or pool.is_complete(*group):
                    continue
                if pool.never_completable(*group):
                    continue
                if pool.budget_deferred(*group):
                    continue
                todo[(key.shard_id, key.block_start, key.volume)] = shard
        admitted = 0
        for (shard_id, block_start, volume), shard in todo.items():
            try:
                admitted += shard.readmit_fileset(
                    FilesetID(self.namespace, shard_id, block_start, volume)
                )
            except Exception:
                _M_READMIT_FAILURES.inc()
                raise
        return admitted

    def _fetch_resident(self, docs, start_nanos, end_nanos):
        """Batched decode-from-residency fetch (kernel R over the resident
        lane assembly): [(tags, times, values)] exact, or None to fall
        back. Lanes the device decoder bails on (annotated streams) re-read
        through the host, batched per block."""
        plan = self._resident_plan(docs, start_nanos, end_nanos)
        if plan is None:
            return None
        flat_keys = [key for _, doc_keys in plan for key in doc_keys]
        decoded = ([], np.zeros(0, bool))
        # this path replaces db.fetch_tagged_arrays, so it emits the same
        # storage.fetch_tagged span
        span = (
            TRACER.span("storage.fetch_tagged", namespace=self.namespace)
            if TRACER.active()
            else NOOP_SPAN
        )
        with span:
            if flat_keys:
                decoded = resident_fetch_arrays(self.db.resident_pool, flat_keys)
                if decoded is None:
                    # raced an eviction: the streamed fallback serves it
                    stats.add_routing(
                        b"*", None, "streamed",
                        "resident-plan-failed (raced eviction)",
                    )
                    return None
            self._record_resident_routing(plan)
            arrays, err = decoded
            out = []
            pos = 0
            err_docs = []
            err_slots: list[int] = []
            with stats.stage("decode"):
                for doc, doc_keys in plan:
                    lanes = arrays[pos : pos + len(doc_keys)]
                    lane_err = err[pos : pos + len(doc_keys)]
                    pos += len(doc_keys)
                    if lane_err.any():
                        # blocks are disjoint, so a full per-series host
                        # read replaces all its lanes (batched below)
                        err_docs.append(doc)
                        err_slots.append(len(out))
                        out.append(None)
                        continue
                    if lanes:
                        times = np.concatenate([t for t, _ in lanes])
                        vals = np.concatenate([v for _, v in lanes])
                    else:
                        times = np.zeros(0, np.int64)
                        vals = np.zeros(0, np.float64)
                    lo = int(np.searchsorted(times, start_nanos, side="left"))
                    hi = int(np.searchsorted(times, end_nanos, side="left"))
                    out.append((doc.fields, times[lo:hi], vals[lo:hi]))
                if err_docs:
                    stitched = self.host_stitch_arrays(
                        err_docs, start_nanos, end_nanos
                    )
                    for slot, doc in zip(err_slots, err_docs):
                        t, v = stitched[doc.id]
                        out[slot] = (doc.fields, t, v)
            span.set_tag("series", len(out))
        return out

    def scan_totals(self, matchers, start_nanos, end_nanos) -> dict:
        """Direct scan-and-aggregate over raw samples: index-resolve the
        matchers, then either decode-from-residency (all matched blocks
        resident: B1 over the resident lane assembly) or upload-and-decode
        (streamed: B1 over the prescanned streams) — the same kernel and
        reduction shapes, so the two paths agree bit for bit.

        Granularity is BLOCK-aligned: totals cover every datapoint of
        blocks overlapping [start, end). Returns {"sum", "count", "min",
        "max", "series", "path", "decoder"} with path "resident" |
        "streamed"."""
        q = matchers_to_index_query(matchers)
        ns = self.db.namespaces[self.namespace]
        # ONE index resolution, shared by the resident plan and fallback
        docs = self.db.query_ids(self.namespace, q, start_nanos, end_nanos).docs
        n_series = len(docs)
        plan = self._resident_plan(docs, start_nanos, end_nanos)
        aggs = None
        path = "streamed"
        stream_for = None  # lane idx -> stream bytes (err-lane stitching)
        if plan is not None:
            flat_keys = [key for _, doc_keys in plan for key in doc_keys]
            aggs = (
                resident_scan_totals(self.db.resident_pool, flat_keys)
                if flat_keys
                else _EMPTY_TOTALS
            )
            if aggs is None:
                stats.add_routing(
                    b"*", None, "streamed",
                    "resident-plan-failed (raced eviction)",
                )
            else:
                path = "resident"
                stats.add(resident_hits=1)
                self._record_resident_routing(plan)

                def stream_for(i, _keys=flat_keys):
                    key = _keys[i]
                    shard = ns.shards[key.shard_id]
                    reader = shard.reader_or_none(
                        FilesetID(
                            key.namespace, key.shard_id, key.block_start, key.volume
                        )
                    )
                    return (reader.stream(key.series_id) or b"") if reader else b""

        if aggs is None:
            pool = getattr(self.db, "resident_pool", None)
            if pool is not None:
                stats.add(resident_misses=1)
            segments: list[bytes] = []
            chunk_ks: set[int] = set()
            streamed_per_shard: dict[int, int] = {}
            for doc in docs:
                shard = ns.shard_for(doc.id)
                for stream, _bound, chunk_k in shard.scan_segments(
                    doc.id, start_nanos, end_nanos
                ):
                    segments.append(stream)
                    chunk_ks.add(chunk_k)
                    streamed_per_shard[shard.id] = (
                        streamed_per_shard.get(shard.id, 0) + len(stream)
                    )
            if pool is not None:
                # per-shard streamed-fallback bytes: the transfer cost
                # residency would have removed
                for shard_id, nbytes in streamed_per_shard.items():
                    pool.heat.charge(shard_id, streamed_bytes=nbytes)
            # decode with the filesets' chunk size so the streamed twin's
            # chunk decomposition (and hence f32 reduction order) matches
            # the resident path bit for bit
            k = chunk_ks.pop() if len(chunk_ks) == 1 else CHUNK_K
            aggs = (
                streamed_scan_totals(segments, k=k, device=self.db.device)
                if segments
                else _EMPTY_TOTALS
            )
            stream_for = lambda i, _segs=segments: _segs[i]
            self._maybe_readmit(docs, start_nanos, end_nanos)
        err = getattr(aggs, "series_err", None)
        if err is not None and np.asarray(err).any():
            # lanes the device decoder bailed on (annotated streams):
            # recompute them through the host codec and rebuild the totals
            aggs = stitch_host_errors(aggs, stream_for)
        count = int(aggs.total_count)
        stats.add(series=n_series, datapoints=count)
        return {
            "sum": float(aggs.total_sum),
            "count": count,
            "min": float(aggs.total_min),
            "max": float(aggs.total_max),
            "series": n_series,
            "path": path,
            "decoder": "chunked",
        }


class BlockStorage:
    """One sealed block, ``chip_smoke.py``'s reference for ``M3Storage``
    (its retirement is queued in ROADMAP): series tags on the host, their
    M3TSZ chunk-lanes packed series-major on the device.

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
        the device, decode (kernel R), consolidate (kernel B-1), and re-read
        on the host the rows the device decoder bailed on (err). Returns
        (metas, values float64[S, T] on the device, datapoints)."""
        sel = self.match(matchers)
        c = self.num_chunks
        lanes = (torch.from_numpy(sel).to(self.device)[:, None] * c
                 + torch.arange(c, device=self.device)[None, :]).reshape(-1)
        res = chunked.decode_chunked(
            self.packed.windows[:, lanes], self.packed.lanes[:, lanes], s=sel.size, c=c, k=self.k
        )
        values, counts = consolidate_grid(res, start_nanos, end_nanos, grid, lookback_nanos)
        # one read back: the datapoints, then the err rows
        out = torch.cat([counts.sum(dtype=torch.int64).view(1), res.err.to(torch.int64)]).cpu()
        datapoints = int(out[0])
        for i in np.flatnonzero(out[1:].numpy()).tolist():
            dps = [dp for dp in decode(self.streams[int(sel[i]) % len(self.streams)])
                   if start_nanos <= dp.timestamp < end_nanos]
            row = consolidate_row(
                np.asarray([dp.timestamp for dp in dps], np.int64),
                np.asarray([dp.value for dp in dps], np.float64),
                np.asarray(grid, np.int64), lookback_nanos,
            )
            values[i] = torch.from_numpy(row).to(values.device)
        return [self.metas[i] for i in sel], values, datapoints
