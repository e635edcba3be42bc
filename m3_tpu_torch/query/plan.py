"""Device query plans: a range query's fetch and consolidation with one
readback.

Port of ``m3_tpu/query/plan.py``. The staged path (``M3Storage.fetch``,
then ``engine.consolidate``) resolves the index to the host, walks each
doc's block keys, plans a gather, decodes and consolidates in a Python loop
over rows. The ``Planner`` serves an eligible fetch as one run on the device
with one device-to-host read at its end:

    index match: the leaves' postings spans -> one K2 launch
      (index/device/kernels.bitmap_from_spans) -> the bitmap algebra
      -> matched-doc compaction (a cumsum over the doc bitmap)
      -> per-lane table gather (the plan's per-(doc, block) tables, on the
         device once per plan)
      -> resident assembly, kernel B-2 (parallel/scan.assemble_lane_rows)
      -> records decode, kernel R (ops/chunked.decode_chunked)
      -> step-grid consolidation, kernel B-1 (``consolidate_grid``)
      -> ONE read back: the match count, the datapoints, the doc bitmap and
         the err rows (the values stay on the device for the engine).

Where the reference runs K1 inside its one program, the port runs K1 when
the plan is built and keeps each leaf's postings spans on the plan: K2's
launch lays its spans out on the host (``index_kernels.cu``), and the
matched terms are a pure function of the plan's key (the matchers) and its
validity stamp, as the reference's matched-doc cache is. A warm execution
launches K2 from the cached spans. The bitmaps equal the reference's.

Bit-identity with the staged path is structural: B-1 picks with the
staged path's upper-bound rule (``engine.consolidate_row``) and builds each
value with ``ops/decode.finalize_values``' exact f64 arithmetic.

Plan cache: an LRU keyed by (namespace, matchers, block set, padded grid
length), as the reference keys it, so hits and misses agree with its.
Entries revalidate per execution against pool eviction and invalidation
counters, shard fileset epochs and index-segment identity. Ineligible
queries raise ``Ineligible`` with the reference's routing reason
(host-regexp leaf, non-resident block, buffer overlay, multi-segment
index, ...) and run staged. Each execution is one ``query_plan`` dispatch
of its ``KernelProfiler`` (``PROF``), whose launches go through no other
profiled seam: a warm plan-served fetch adds exactly one to the query's
``device_dispatches``. The reference's compile counter has no counterpart:
PyTorch compiles nothing here.

Knobs (the reference's own):

    M3_TPU_QUERY_PLAN          "0" disables planning entirely
    M3_TPU_QUERY_PLAN_CACHE    LRU entries (default 64)
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from contextlib import contextmanager

import numpy as np
import torch

from .. import device_guard
from ..ops import decode as D
from ..ops._build import launch_error, load_library
from ..utils.instrument import DEFAULT as METRICS
from ..utils.instrument import KernelProfiler

_M_HITS = METRICS.counter(
    "query_plan_hits_total",
    "fetches served by a cached device query plan (one readback)",
)
_M_MISSES = METRICS.counter(
    "query_plan_misses_total",
    "device query plans built (cache miss: first sighting, or a stamp "
    "mismatch after segment swap / volume bump / eviction)",
)
_M_FALLBACKS = METRICS.counter(
    "query_plan_fallbacks_total",
    "fetches that degraded to the staged executor (the routing record says "
    "why, per cause)",
)
_M_ERRORS = METRICS.counter(
    "query_plan_errors_total",
    "device plan executions that raised (the port raises them to the query: "
    "a device fault is not hidden behind the staged result)",
)
_M_COALESCED = METRICS.counter(
    "query_plan_coalesced_total",
    "fetches served by joining another concurrent query's in-flight "
    "device scan (N concurrent identical fetches -> 1 dispatch)",
)

_SENTINEL_GRID = 8  # minimum padded grid length (the cache key's)

# dispatch observability for a plan execution: one dispatch per
# plan-served fetch (charged to the query's ``device_dispatches`` through
# the stats seam), sampled dispatch seconds in
# m3tpu_kernel_dispatch_seconds{kernel="query_plan"}
PROF = KernelProfiler("query_plan")

# Launches of B-1, counted by consolidate_grid where it launches.
LAUNCHES = 0


def pad_pow2(n: int, lo: int = 1) -> int:
    """The next power of two at or above ``n``, at least ``lo`` (the
    reference's ``index/device/kernels.pad_pow2``)."""
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def plan_enabled() -> bool:
    return os.environ.get("M3_TPU_QUERY_PLAN", "1") != "0"


def _cache_cap() -> int:
    try:
        return max(int(os.environ.get("M3_TPU_QUERY_PLAN_CACHE", "64")), 1)
    except ValueError:
        return 64


# ---------------------------------------------------------------------------
# force-staged probe (the bit-identity surface)
# ---------------------------------------------------------------------------

_FORCE = threading.local()


@contextmanager
def force_staged():
    """Disable device plans for this thread's queries (the parity probe:
    run a query fused and force-staged and compare the bits)."""
    prev = getattr(_FORCE, "on", False)
    _FORCE.on = True
    try:
        yield
    finally:
        _FORCE.on = prev


def staged_forced() -> bool:
    return getattr(_FORCE, "on", False)


class Ineligible(Exception):
    """Query/plan state the plan does not cover: the caller records
    ``reason`` in the routing record and runs the staged path."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


# ---------------------------------------------------------------------------
# B-1: step-grid consolidation
# ---------------------------------------------------------------------------


def consolidate_grid(res: D.DecodeResult, lo: int, hi: int, grid, lookback: int):
    """Records [S, P] (time-ordered over each row's valid records) -> the
    step grid: (values float64 [S, T], NaN where no sample is in the
    lookback window; counts int32 [S], each row's valid records in
    ``[lo, hi)``), on the records' device. ``grid`` is the int64 step
    timestamps. A CUDA tensor launches kernel B-1
    (``query/csrc/consolidate_grid.cu``; raises if the build or the launch
    fails), a CPU tensor runs the twin. Nothing is read back: callers sum
    the counts after their own readback."""
    if res.ts.device.type == "cpu":
        return consolidate_grid_reference(res, lo, hi, grid, lookback)
    return launch_consolidate_grid(res, lo, hi, grid, lookback)


def launch_consolidate_grid(res: D.DecodeResult, lo: int, hi: int, grid, lookback: int,
                            tile: int = 0, run: int = 0):
    """Kernel B-1's launch behind ``consolidate_grid``: ``tile`` records a
    warp stages at once (0: the row, up to ``m3_consolidate_grid_tile_records``)
    and ``run`` steps a lane takes a pass (0: ceil(T / 32), up to 24). The
    card tests force both to reach the kernel's tiles and passes."""
    global LAUNCHES
    dev = res.ts.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    s, p = res.ts.shape
    if isinstance(grid, torch.Tensor):
        g = grid.to(device=dev, dtype=torch.int64).contiguous()
    else:  # through pinned memory: a pageable copy would wait for the card first
        g = torch.from_numpy(np.ascontiguousarray(grid, np.int64)).pin_memory().to(
            dev, non_blocking=True)
    t = g.numel()
    values = torch.empty((s, t), dtype=torch.float64, device=dev)
    if s == 0 or p == 0:
        values.fill_(torch.nan)
        return values, torch.zeros(s, dtype=torch.int32, device=dev)
    counts = torch.empty(s, dtype=torch.int32, device=dev)  # the kernel writes every row's
    if p > 0x7FFFFFFF:
        raise ValueError(f"consolidate_grid: {p} records a row exceed 2**31")
    want = {"ts": torch.int64, "bits": torch.int64, "point_is_float": torch.bool,
            "mult": torch.uint8, "valid": torch.bool}
    ins = {}
    for name, dtype in want.items():
        x = getattr(res, name)
        if x.dtype != dtype or x.shape != (s, p) or x.device != dev:
            raise ValueError(f"consolidate_grid: {name} must be {dtype} [{s}, {p}] on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        ins[name] = x.contiguous()
    lib = load_library("consolidate_grid")
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_consolidate_grid(
            ins["ts"].data_ptr(), ins["bits"].data_ptr(), ins["point_is_float"].data_ptr(),
            ins["mult"].data_ptr(), ins["valid"].data_ptr(), s, p, int(lo), int(hi),
            g.data_ptr(), t, int(lookback), values.data_ptr(), counts.data_ptr(), int(tile),
            int(run), stream,
        )
    if rc != 0:
        raise launch_error("consolidate_grid", rc, **ins, grid=g, values=values, counts=counts)
    LAUNCHES += 1
    return values, counts


def consolidate_grid_shape(s: int, p: int, t: int, tile: int = 0, run: int = 0,
                           device="cuda") -> dict:
    """How kernel B-1 runs [s, p] records onto t steps: warps a block, the
    blocks the card holds at once and those the launch starts, shared
    memory a block, registers a thread, whether the grid sits in shared
    memory, records a tile and steps a lane takes a pass."""
    import ctypes

    out = (ctypes.c_int64 * 8)()
    with device_guard(torch.device(device)):
        rc = load_library("consolidate_grid").m3_consolidate_grid_shape(s, p, t, tile, run, out)
    if rc != 0:
        raise RuntimeError(f"consolidate_grid_shape({s}, {p}, {t}): CUDA error {rc}")
    keys = ("warps", "resident_blocks", "smem_bytes", "registers", "grid_in_smem", "tile", "run",
            "blocks")
    return dict(zip(keys, (int(x) for x in out)))


def consolidate_grid_reference(res: D.DecodeResult, lo: int, hi: int, grid, lookback: int):
    """Plain torch twin of B-1: the value at grid step t is the last valid
    sample in (t - lookback, t], the rule of ``engine.consolidate_row``.
    Timestamps are native int64; the result equals the host rule bit for
    bit in float64."""
    ts = res.ts
    dev = ts.device
    s, p = ts.shape
    g = torch.as_tensor(np.asarray(grid, np.int64) if not isinstance(grid, torch.Tensor)
                        else grid, dtype=torch.int64).to(dev)
    valid = res.valid & (ts >= lo) & (ts < hi)
    counts = valid.sum(dim=1, dtype=torch.int32)
    if s == 0 or p == 0:
        return torch.full((s, g.numel()), torch.nan, dtype=torch.float64, device=dev), counts
    # forward-fill the source index of the last valid record at or before
    # each slot; leading slots with none keep -1 and the smallest timestamp,
    # so the filled timestamps are non-decreasing along every row
    src = torch.where(valid, torch.arange(p, device=dev), -1)
    fsrc = torch.cummax(src, dim=1).values
    have = fsrc >= 0
    fsrc_c = fsrc.clamp(min=0)
    fts = torch.where(have, ts.gather(1, fsrc_c), torch.iinfo(torch.int64).min)
    # upper bound per (row, step): first slot whose filled timestamp > t
    idx = torch.searchsorted(fts, g.expand(s, -1).contiguous(), right=True) - 1
    idc = idx.clamp(min=0)
    pick = fsrc_c.gather(1, idc)
    ok = (idx >= 0) & have.gather(1, idc) & (g[None, :] - ts.gather(1, pick) < lookback)
    values = D.finalize_values(
        res.bits.gather(1, pick), res.point_is_float.gather(1, pick), res.mult.gather(1, pick)
    )
    return torch.where(ok, values, torch.nan), counts


# ---------------------------------------------------------------------------
# AST shape extraction
# ---------------------------------------------------------------------------


def _ast_shape(q, arrays, leaves: list, ranges: list):
    """Index query AST -> a tree whose leaves reference slots in
    ``leaves`` (exact-match (field, value) rows, one K1 row each) and
    ``ranges`` ((lo, hi) global term ranges, host-narrowed). Raises
    Ineligible for nodes the device cannot model (general regexps keep
    their automaton on the host)."""
    from ..index.device.segment import classify_regexp
    from ..index.query import (
        AllQuery,
        ConjunctionQuery,
        DisjunctionQuery,
        FieldQuery,
        NegationQuery,
        RegexpQuery,
        TermQuery,
    )

    def leaf(field: bytes, values: list):
        slot = len(leaves)
        leaves.extend((field, v) for v in values)
        return ("terms", slot, len(values))

    def rng(lo: int, hi: int):
        ranges.append((lo, hi))
        return ("range", len(ranges) - 1)

    def walk(node):
        if isinstance(node, TermQuery):
            return leaf(node.field, [node.value])
        if isinstance(node, RegexpQuery):
            kind, val = classify_regexp(node.pattern)
            if kind == "literal":
                return leaf(node.field, [val])
            if kind == "alternation":
                return leaf(node.field, list(val))
            if kind == "prefix" and arrays.dot_safe:
                start, count = arrays.fields.get(node.field, (0, 0, 0, 0))[:2]
                return rng(*_prefix_bounds(arrays, val, start, start + count))
            raise Ineligible("host-regexp-leaf")
        if isinstance(node, FieldQuery):
            start, count = arrays.fields.get(node.field, (0, 0, 0, 0))[:2]
            return rng(start, start + count)
        if isinstance(node, AllQuery):
            return ("all",)
        if isinstance(node, ConjunctionQuery):
            pos = [walk(s) for s in node.queries if not isinstance(s, NegationQuery)]
            negs = [walk(s.query) for s in node.queries if isinstance(s, NegationQuery)]
            return ("and", tuple(pos), tuple(negs))
        if isinstance(node, DisjunctionQuery):
            return ("or", tuple(walk(s) for s in node.queries))
        if isinstance(node, NegationQuery):
            return ("not", walk(node.query))
        raise Ineligible(f"unsupported-node:{type(node).__name__}")

    return walk(q)


def _prefix_bounds(arrays, prefix: bytes, lo: int, hi: int):
    """Host prefix narrow over the key-matrix mirror, identical to
    DeviceSegment._prefix_range (the shared compare in kernels.py)."""
    from ..index.device import kernels
    from ..index.segment import prefix_upper

    width = 4 * arrays.k_words
    if len(prefix) > width:
        return lo, lo
    pk, pl = kernels.build_term_keys([prefix], arrays.k_words)
    lo = kernels.host_lower_bound(arrays.host_keys, arrays.host_lens, lo, hi, pk[0], int(pl[0]))
    up = prefix_upper(prefix)
    if up is not None and len(up) <= width:
        uk, ul = kernels.build_term_keys([up], arrays.k_words)
        hi = kernels.host_lower_bound(arrays.host_keys, arrays.host_lens, lo, hi, uk[0],
                                      int(ul[0]))
    return lo, hi


def _leaf_spans(tree, arrays, gis: np.ndarray, ranges: list, spans: list):
    """The tree with its leaves as K2 rows: ("row", r), r's postings spans
    (int64 [m, 2]) appended to ``spans`` — a term leaf's are its matched
    terms' (K1's answer ``gis``), a range's the one run of its terms."""
    from ..index.device import kernels

    kind = tree[0]
    if kind == "terms":
        _, slot, n = tree
        spans.append(kernels.term_spans(arrays.host_post_idx, gis[slot : slot + n]))
        return ("row", len(spans) - 1)
    if kind == "range":
        lo, hi = ranges[tree[1]]
        pi = arrays.host_post_idx
        run = [(int(pi[lo, 0]), int(pi[hi - 1, 1]))] if hi > lo else []
        spans.append(np.asarray(run, np.int64).reshape(-1, 2))
        return ("row", len(spans) - 1)
    if kind == "and":
        return ("and", tuple(_leaf_spans(s, arrays, gis, ranges, spans) for s in tree[1]),
                tuple(_leaf_spans(s, arrays, gis, ranges, spans) for s in tree[2]))
    if kind == "or":
        return ("or", tuple(_leaf_spans(s, arrays, gis, ranges, spans) for s in tree[1]))
    if kind == "not":
        return ("not", _leaf_spans(tree[1], arrays, gis, ranges, spans))
    return tree  # ("all",)


def _combine(tree, rows, arrays):
    """The bitmap algebra of the reference's program over K2's rows."""
    kind = tree[0]
    if kind == "row":
        return rows[tree[1]]
    if kind == "all":
        return arrays.all_words
    if kind == "and":
        _, pos, negs = tree
        acc = _combine(pos[0], rows, arrays) if pos else arrays.all_words
        for s in pos[1:]:
            acc = acc & _combine(s, rows, arrays)
        for s in negs:
            acc = acc & ~_combine(s, rows, arrays)
        return acc
    if kind == "or":
        acc = torch.zeros(arrays.n_words, dtype=torch.int32, device=arrays.device)
        for s in tree[1]:
            acc = acc | _combine(s, rows, arrays)
        return acc
    return arrays.all_words & ~_combine(tree[1], rows, arrays)  # "not"


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """bool [32 * w] -> int64 [w] of u32 words, bit j of word i = x[32i + j]."""
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return (x.view(-1, 32).to(torch.int64) << shifts).sum(dim=1)


# ---------------------------------------------------------------------------
# plan entries + planner
# ---------------------------------------------------------------------------


class _PlanEntry:
    """One cached plan: the leaves' postings spans and the bitmap tree over
    them, the lane tables on the device for its (segment, block set), and
    the validity stamp it revalidates against per execution."""

    __slots__ = (
        "seg", "arrays", "tree", "spans", "n_rows", "lanes", "n_blocks", "cap",
        "stamp", "chunk_k", "matched", "key",
    )


class _Flight:
    """One in-flight coalesced device scan: the leader executes, every
    follower that arrives while it runs blocks on ``event`` and shares
    the result (or the exception: an Ineligible leader means every
    follower is ineligible the same way and runs staged itself)."""

    __slots__ = ("event", "result", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None


class Planner:
    """Per-storage device query planner with an LRU plan cache."""

    def __init__(self, db, namespace: str) -> None:
        self.db = db
        self.namespace = namespace
        self._cache: "OrderedDict[tuple, _PlanEntry]" = OrderedDict()
        self._lock = threading.Lock()
        # scan coalescing (singleflight): identical concurrent fetches
        # keyed by (plan key, window, grid) share ONE execution
        self._flights: dict[tuple, _Flight] = {}
        self.hits = 0
        self.misses = 0
        self.fallbacks = 0
        self.coalesced = 0

    def evict_stale(self) -> int:
        """Drop cached plans whose pool/fileset stamp no longer holds (the
        fallback path calls it), so entries built against evicted or
        invalidated state release their device tables and the segment
        arrays they keep alive instead of lingering until LRU
        displacement."""
        pool = getattr(self.db, "resident_pool", None)
        namespaces = getattr(self.db, "namespaces", None)
        if pool is None or namespaces is None or self.namespace not in namespaces:
            return 0
        ns = namespaces[self.namespace]
        live = (
            pool.evictions, pool.invalidations,
            tuple(sh.fileset_epoch for sh in ns.shards),
        )
        with self._lock:
            stale = [k for k, e in self._cache.items() if e.stamp[2:] != live]
            for k in stale:
                del self._cache[k]
        return len(stale)

    def run(self, matchers, fetch_lo: int, fetch_hi: int, grid: np.ndarray,
            lookback_nanos: int):
        """Serve one fetch through a device plan. Returns ((matched docs,
        metas), values f64 [S, T] on the pool's device, datapoints, err
        rows) or raises Ineligible with the routing reason (the caller
        records it and runs staged). ``grid`` is the engine's consolidation
        timestamp vector.

        Concurrent identical fetches COALESCE: while one thread's execution
        is in flight, any other thread arriving with the same (plan key,
        window, grid) joins it instead of dispatching its own; a joiner
        records plan_coalesced and no device dispatch."""
        if not plan_enabled():
            raise Ineligible("plan-disabled")
        if staged_forced():
            raise Ineligible("force-staged")
        db = self.db
        namespaces = getattr(db, "namespaces", None)
        if namespaces is None or self.namespace not in namespaces:
            raise Ineligible("remote-storage")
        pool = getattr(db, "resident_pool", None)
        if pool is None or not pool.enabled:
            raise Ineligible("resident-pool-disabled")
        ns = namespaces[self.namespace]
        if ns.index is None:
            raise Ineligible("no-index")
        seg, arrays = self._single_device_segment(ns.index, fetch_lo, fetch_hi)
        blocks = self._block_set(ns, pool, fetch_lo, fetch_hi)
        if not blocks:
            raise Ineligible("no-sealed-blocks")
        for shard in ns.shards:
            if shard.has_buffered_overlap(fetch_lo, fetch_hi):
                raise Ineligible("buffer-overlay")

        from . import stats
        from .m3_storage import matchers_to_index_query

        q = matchers_to_index_query(matchers)
        grid = np.asarray(grid, np.int64)
        t_grid = pad_pow2(len(grid), _SENTINEL_GRID)
        key = (
            self.namespace,
            tuple((m.name, m.op, m.value) for m in matchers),
            tuple(blocks),
            t_grid,
        )
        fkey = key + (fetch_lo, fetch_hi, grid.tobytes(), lookback_nanos)
        with self._lock:
            fl = self._flights.get(fkey)
            leader = fl is None
            if leader:
                fl = self._flights[fkey] = _Flight()
        if not leader:
            fl.event.wait()
            if fl.error is not None:
                if isinstance(fl.error, Ineligible):
                    # a fresh instance per thread: the reason is shared,
                    # the traceback must not be
                    raise Ineligible(fl.error.reason)
                raise fl.error
            self.coalesced += 1
            _M_COALESCED.inc()
            stats.add(plan_coalesced=1)
            matched, values, datapoints, err_rows = fl.result
            # own values per follower: the err-row stitch and downstream
            # transforms may write rows
            return matched, values.clone(), datapoints, err_rows
        try:
            result = self._run_leader(
                key, q, seg, arrays, ns, pool, blocks, fetch_lo, fetch_hi, grid, lookback_nanos,
            )
            fl.result = result
            return result
        except BaseException as exc:
            fl.error = exc
            raise
        finally:
            with self._lock:
                self._flights.pop(fkey, None)
            fl.event.set()

    def _run_leader(self, key, q, seg, arrays, ns, pool, blocks, fetch_lo: int, fetch_hi: int,
                    grid: np.ndarray, lookback_nanos: int):
        from . import stats

        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
        if entry is not None and self._valid(entry, seg, arrays, ns, pool):
            self.hits += 1
            _M_HITS.inc()
            stats.add(plan_hits=1)
            return self._execute(entry, ns, fetch_lo, fetch_hi, grid, lookback_nanos)
        entry = self._build(q, seg, arrays, ns, pool, blocks)
        with self._lock:
            self._cache[key] = entry
            self._cache.move_to_end(key)
            while len(self._cache) > _cache_cap():
                self._cache.popitem(last=False)
        self.misses += 1
        _M_MISSES.inc()
        stats.add(plan_misses=1)
        return self._execute(entry, ns, fetch_lo, fetch_hi, grid, lookback_nanos)

    # -- eligibility pieces ------------------------------------------------

    @staticmethod
    def _single_device_segment(index, fetch_lo: int, fetch_hi: int):
        """The range's ONE sealed, device-resident index segment (the plan's
        scope; more segments or mutable docs degrade staged)."""
        with index.lock:
            segs = []
            mutable_docs = 0
            for bs in sorted(index.blocks):
                if bs + index.block_size <= fetch_lo or bs >= fetch_hi:
                    continue
                blk = index.blocks[bs]
                mutable_docs += len(blk.mutable)
                segs.extend(blk.sealed)
        if mutable_docs:
            raise Ineligible("mutable-index-block")
        if not segs:
            raise Ineligible("no-index-segment")
        if len(segs) > 1:
            raise Ineligible("multi-segment")
        seg = segs[0]
        arrays = getattr(seg, "_arrays", None)
        if arrays is None:
            raise Ineligible("index-not-resident")
        return seg, arrays

    def _block_set(self, ns, pool, fetch_lo: int, fetch_hi: int):
        """Sorted ((shard, block_start, volume)) of every sealed fileset
        overlapping the range: each must be complete-admitted so a
        page-table miss means 'series absent', never 'not resident'."""
        out = []
        bsz = ns.opts.block_size_nanos
        for shard in ns.shards:
            newest: dict[int, int] = {}
            for fid in shard.filesets():
                if fid.block_start + bsz <= fetch_lo or fid.block_start >= fetch_hi:
                    continue
                cur = newest.get(fid.block_start)
                if cur is None or fid.volume > cur:
                    newest[fid.block_start] = fid.volume
            for bs, vol in newest.items():
                if not pool.is_complete(self.namespace, shard.id, bs, vol):
                    raise Ineligible("non-resident-block")
                out.append((shard.id, bs, vol))
        return sorted(out, key=lambda t: (t[1], t[0]))

    def _stamp(self, seg, arrays, ns, pool):
        return (
            id(seg), id(arrays),
            pool.evictions, pool.invalidations,
            tuple(sh.fileset_epoch for sh in ns.shards),
        )

    def _valid(self, entry, seg, arrays, ns, pool) -> bool:
        return entry.stamp == self._stamp(seg, arrays, ns, pool)

    # -- build -------------------------------------------------------------

    def _build(self, q, seg, arrays, ns, pool, blocks) -> _PlanEntry:
        from ..cache.block_cache import BlockKey
        from ..index.device.segment import match_rows
        from ..ops.chunked import window_words
        from ..parallel.scan import LaneRows

        # stamp BEFORE the page-table walk: an eviction racing the walk
        # would otherwise free (and let a re-admission reuse) pages this
        # plan just copied into its tables while the stamp still matched
        # current counters; the in-lease re-check in _execute must see a
        # stamp OLDER than any such churn and refuse to serve
        stamp = self._stamp(seg, arrays, ns, pool)
        leaves: list = []
        ranges: list = []
        tree = _ast_shape(q, arrays, leaves, ranges)

        docs = list(seg.docs)
        n_docs = len(docs)
        if n_docs == 0:
            raise Ineligible("empty-segment")
        block_starts = sorted({bs for _, bs, _ in blocks})
        vols = {(sh, bs): vol for sh, bs, vol in blocks}
        n_blocks = len(block_starts)

        # per-(doc, block) lane rows; one trailing all-zero doc row block is
        # the compaction sentinel (padding slots decode nothing). The doc
        # axis pads to the bitmap's 32-aligned width, so the bit unpack and
        # the compaction agree on capacity.
        n_docs_pad = arrays.n_words * 32
        rows = (n_docs_pad + 1) * n_blocks
        chunk_k = 0
        max_span = 0
        max_pages = 1
        max_side = 1
        lane_entries: list = [None] * rows
        for d, doc in enumerate(docs):
            shard = ns.shard_for(doc.id)
            for b, bs in enumerate(block_starts):
                vol = vols.get((shard.id, bs))
                if vol is None:
                    continue  # this shard has no fileset for the block
                e = pool.get(BlockKey(self.namespace, shard.id, bytes(doc.id), bs, vol))
                if e is None:
                    # complete-admitted fileset without the series: the
                    # series is absent from the block, an empty lane
                    continue
                if e.n_chunks <= 0 or not e.side_pages:
                    raise Ineligible("missing-side-planes")
                if chunk_k == 0:
                    chunk_k = e.chunk_k
                elif e.chunk_k != chunk_k:
                    raise Ineligible("mixed-chunk-k")
                lane_entries[d * n_blocks + b] = (e, bs)
                max_span = max(max_span, e.max_span_bits)
                max_pages = max(max_pages, len(e.pages))
                max_side = max(max_side, len(e.side_pages))
        if chunk_k == 0:
            raise Ineligible("no-resident-lanes")

        o = pool.options
        cw = window_words(max_span)
        extra = -(-cw // o.page_words) + 1
        lp = max_pages + extra
        sl = max_side
        c = max((e.n_chunks for e, _ in filter(None, lane_entries)), default=1)
        t_pages = np.zeros((rows, lp), np.int32)
        t_sides = np.zeros((rows, sl), np.int32)
        t_chunks = np.zeros(rows, np.int32)
        t_bits = np.zeros(rows, np.int32)
        t_bhi = np.zeros(rows, np.uint32)
        t_blo = np.zeros(rows, np.uint32)
        for i, le in enumerate(lane_entries):
            if le is None:
                continue
            e, bs = le
            pool._check_entry(e)
            t_pages[i, : len(e.pages)] = e.pages
            t_sides[i, : len(e.side_pages)] = e.side_pages
            t_chunks[i] = e.n_chunks
            t_bits[i] = e.num_bits
            t_bhi[i] = (int(bs) >> 32) & 0xFFFFFFFF
            t_blo[i] = int(bs) & 0xFFFFFFFF

        # the leaves' K1 match, once: the matched terms are fixed while the
        # stamp holds (the entry is keyed by the matchers), so their
        # postings spans ride the entry and every execution launches K2
        # from them
        gis = np.zeros(0, np.int32)
        if leaves:
            lo = np.zeros(len(leaves), np.int32)
            hi = np.zeros(len(leaves), np.int32)
            for i, (field, _v) in enumerate(leaves):
                start, count = arrays.fields.get(field, (0, 0, 0, 0))[:2]
                lo[i], hi[i] = start, start + count
            gis = match_rows(arrays.term_keys, arrays.term_lens, lo, hi,
                             [v for _, v in leaves], arrays.k_words, arrays.device)
        leaf_spans: list = []
        tree = _leaf_spans(tree, arrays, gis, ranges, leaf_spans)
        spans = (np.concatenate([
            np.column_stack([np.full(len(sp), r, np.int64), sp])
            for r, sp in enumerate(leaf_spans)
        ]) if leaf_spans else np.zeros((0, 3), np.int64))

        dev = pool.device
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
        entry = _PlanEntry()
        entry.seg = seg
        entry.arrays = arrays
        entry.tree = tree
        entry.spans = spans
        entry.n_rows = len(leaf_spans)
        entry.lanes = LaneRows(
            vecs=[put(x) for x in (t_pages, t_sides, t_chunks, t_bits, t_bhi, t_blo)],
            total_bits=t_bits, n_chunks=t_chunks, num_chunks=c, window_words=cw,
            page_words=o.page_words, side_page_chunks=o.side_page_chunks,
        )
        entry.n_blocks = n_blocks
        # decode capacity = bitmap width, whatever the match count, so a
        # warm execution reads nothing back before its end
        entry.cap = n_docs_pad
        entry.chunk_k = chunk_k
        entry.stamp = stamp
        # the query_plan dispatch key (with the grid length added per
        # execution): the bitmap tree's shape and the plan's dimensions, as
        # the reference keys its program
        entry.key = (repr(tree), arrays.n_words, n_docs_pad, entry.cap, n_blocks, c, chunk_k,
                     cw, o.page_words, o.side_page_chunks)
        # matched-doc cache: the matched set is a pure function of the
        # segment arrays and the matcher values, both frozen while the
        # stamp holds, so the per-doc tag materialization is paid ONCE per
        # plan, not per query
        entry.matched = None
        return entry

    # -- execute -----------------------------------------------------------

    def _execute(self, entry, ns, fetch_lo: int, fetch_hi: int, grid: np.ndarray,
                 lookback_nanos: int):
        from ..index.device import kernels

        pool = self.db.resident_pool
        arrays = entry.arrays
        with pool.read_lease():
            # buffer snapshots under the lease (the staged resident scan's
            # discipline); the plan tables reference page indices, so the
            # validity stamp re-checks INSIDE the lease: an eviction and
            # re-admission racing between run()'s check and this snapshot
            # could otherwise hand reused pages to stale table rows. Under
            # the lease the snapshot is immutable (admissions take the
            # copy path), so a stamp that holds here holds for the launches.
            bufs = pool.buffers()
            if bufs is None:
                raise Ineligible("resident-pool-empty")
            words, side = bufs
            if entry.stamp != self._stamp(entry.seg, arrays, ns, pool):
                raise Ineligible("raced-invalidation")
            # every launch of the execution is ONE query_plan dispatch (the
            # reference's one program); the launches inside go through no
            # profiled wrapper
            with PROF.dispatch(entry.key + (len(grid),)) as d:
                values, summary = d.done(self._launch(
                    entry, words, side, fetch_lo, fetch_hi, grid, lookback_nanos))
        # the ONE device-to-host read: match count, datapoints, the doc
        # bitmap and the err rows, as u32 words in int64
        out = summary.cpu().numpy()
        n, datapoints = int(out[0]), int(out[1])
        nw = arrays.n_words
        if n > entry.cap:
            # more matches than the plan's capacity (a doc-count jump since
            # build): fall back for THIS query; the stamp check rebuilds at
            # the larger size next time
            raise Ineligible("plan-capacity")
        if entry.matched is not None and len(entry.matched[0]) == n:
            matched = entry.matched
        else:
            from ..block.core import SeriesMeta

            doc_ids = kernels.bitmap_to_docids(out[2 : 2 + nw].astype(np.uint32))[:n]
            seg_docs = entry.seg.docs
            matched_docs = [seg_docs[int(i)] for i in doc_ids]
            matched = (matched_docs, [SeriesMeta(tags=d.fields) for d in matched_docs])
            entry.matched = matched
        err = np.unpackbits(out[2 + nw :].astype(np.uint32).view(np.uint8), bitorder="little")
        err_rows = np.flatnonzero(err[:n])
        return matched, values[:n], datapoints, err_rows

    @staticmethod
    def _launch(entry, words, side, fetch_lo: int, fetch_hi: int, grid: np.ndarray,
                lookback_nanos: int):
        """The execution's launches, in order: K2 over the cached spans and
        the bitmap algebra, the matched-doc compaction, B-2 over the
        gathered table rows, R, then B-1. Returns (values, the readback's
        int64 summary) on the device."""
        from ..index.device import kernels
        from ..ops.chunked import decode_chunked
        from ..parallel.scan import assemble_lane_rows

        arrays = entry.arrays
        cap, nb, lanes = entry.cap, entry.n_blocks, entry.lanes
        dev = words.device
        # index: one K2 launch over the cached spans, then the algebra
        rows = (kernels.bitmap_from_spans(arrays.post_data, entry.spans, entry.n_rows,
                                          arrays.n_words) if entry.n_rows else None)
        bitmap = _combine(entry.tree, rows, arrays)
        # matched-doc compaction: doc bitmap -> dense slots, the rest
        # pointing at the sentinel row block
        shifts = torch.arange(32, dtype=torch.int32, device=dev)
        bits = ((bitmap[:, None] >> shifts) & 1).reshape(-1) != 0
        ncum = torch.cumsum(bits, 0)
        slot = torch.where(bits, ncum - 1, cap)
        sel = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
        sel.scatter_(0, slot, torch.arange(cap, device=dev))
        lane_rows = (sel[:cap, None] * nb + torch.arange(nb, device=dev)[None, :]).reshape(-1)
        packed = assemble_lane_rows(words, side, lanes, lane_rows)
        res = decode_chunked(packed.windows, packed.lanes, cap * nb, lanes.num_chunks,
                             entry.chunk_k)
        rs = lambda x: x.reshape(cap, -1)
        res = D.DecodeResult(ts=rs(res.ts), bits=rs(res.bits), point_is_float=rs(res.point_is_float),
                             mult=rs(res.mult), valid=rs(res.valid),
                             err=res.err.reshape(cap, nb).any(dim=1))
        values, counts = consolidate_grid(res, fetch_lo, fetch_hi, grid, lookback_nanos)
        head = torch.stack([ncum[-1], counts.sum(dtype=torch.int64)])
        summary = torch.cat([head, bitmap.to(torch.int64) & 0xFFFFFFFF, _pack_bits(res.err)])
        return values, summary
