"""Scan-and-aggregate: the port's main path.

Port of ``m3_tpu/parallel/scan.py``:

- ``chunked_scan_aggregate_packed``: kernel B1 (``ops/fused.lane_aggregates``)
  folds each packed chunk-lane into six aggregates; plain torch reduces
  them per series and across series, as the JAX package leaves those
  reductions to XLA.
- ``chunked_scan_aggregate_fused``: the same over the per-field layout
  with kernel B3 (``ops/fused.lane_aggregates_fields``).
- the resident lane assembly: device gathers over the resident pool's
  pages and side planes build either layout (``assemble_resident_packed``,
  ``assemble_resident_lanes``; ``assemble_lane_rows`` for the query plan's
  rows of plan vectors already on the device). For a pool on the card they
  launch kernel B-2 (``csrc/resident_assembly.cu``); for a pool on the CPU
  they run its plain torch twin (``_resident_gather``).
- ``scan_aggregate``: the whole-stream decode (kernel B-6,
  ``ops/decode.decode_batched``) of every series from bit 0, then the same
  reductions over its [S, T] f32 values.
- the sharded scans (``make_sharded_chunked_scan``, ``make_sharded_scan``,
  ``sharded_scan_aggregate``, ``make_sharded_resident_chunked_scan``): each
  rank of a ``parallel/mesh.SeriesMesh`` scans its slice of the series on
  its device, and the cross-series totals are all-reduced over the mesh
  (SUM for sum and count, MIN / MAX for the extremes), the reference's
  psum / pmin / pmax over its shard axis; the empty-total NaN rule follows
  the reduce, as there.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import device_guard
from ..ops import decode as D
from ..utils.instrument import KernelProfiler
from ..ops import fused
from ..ops import precise as pr
from .mesh import series_mesh, series_sharding

# dispatch observability for the whole-stream decode (kernel B-6), the
# reference's seam and kernel name: dispatch counts and sampled dispatch
# seconds in m3tpu_kernel_dispatch_seconds{kernel="m3tsz_decode"}
_JIT_DECODE = KernelProfiler("m3tsz_decode")


class ScanAggregates(NamedTuple):
    """Per-series reductions plus cross-series totals."""

    series_sum: torch.Tensor  # f32[S] sum_over_time per series
    series_count: torch.Tensor  # i32[S] valid datapoints per series
    series_min: torch.Tensor  # f32[S]
    series_max: torch.Tensor  # f32[S]
    series_last: torch.Tensor  # f32[S]
    total_sum: torch.Tensor  # f32[]
    total_count: torch.Tensor  # i64[]
    total_min: torch.Tensor  # f32[]
    total_max: torch.Tensor  # f32[]
    series_err: torch.Tensor | None = None  # bool[S] device decode bailed
    #   (annotations etc.) — stitch_host_errors() recomputes those series


def _mesh_totals(mesh, t_sum, t_count, t_min, t_max):
    """The totals all-reduced over ``mesh`` (None: as they are), then the
    empty-total NaN rule (m3_tpu/parallel/scan.py:84-90)."""
    if mesh is not None:
        t_sum = mesh.all_reduce(t_sum, "sum")
        t_count = mesh.all_reduce(t_count, "sum")
        t_min = mesh.all_reduce(t_min, "min")
        t_max = mesh.all_reduce(t_max, "max")
    return (t_sum, t_count, torch.where(t_count > 0, t_min, torch.nan),
            torch.where(t_count > 0, t_max, torch.nan))


def _chunk_order_sum(x: torch.Tensor, s: int, c: int, lane_order: str) -> torch.Tensor:
    """Per-lane sums ``x`` [S*C] added per series in an order that does not
    depend on the series count, so that a sharded scan's series equal the
    whole scan's: a one-call sum over the chunk axis of chunk-major lanes
    picks its order by the series count (on the CPU at any count). Series-
    major rows are an inner reduction, ordered by C alone; chunk-major lanes
    take the last row of one cumulative sum down the chunk axis, which adds
    the chunks in order (the CPU accumulates it in f64, the card in f32)."""
    if lane_order == "s":
        return x.reshape(s, c).sum(dim=1)
    return torch.cumsum(x.reshape(c, s), dim=0)[-1]


def _aggregates_from_lanes(
    lane_agg: fused.LaneAggregates, s: int, c: int, lane_order: str = "s",
    inv=None, precise: bool = False, mesh=None,
) -> ScanAggregates:
    """Reduce per-lane aggregates [S*C] to ScanAggregates.

    ``lane_order``: "s" series-major (lane = s*C + c), "c" chunk-major
    (lane = c*S + s), "sorted" chunk-major with the series axis permuted;
    ``inv`` (int[S]) gathers per-series outputs back to series order.
    ``mesh``: the totals are all-reduced over it."""
    if lane_order in ("c", "sorted"):
        rs = lambda x: x.reshape(c, s).T
    elif lane_order == "s":
        rs = lambda x: x.reshape(s, c)
    else:
        raise ValueError(f"unknown lane order {lane_order!r}")
    unperm = lambda x: x
    if lane_order == "sorted":
        inv_d = torch.as_tensor(np.asarray(inv), dtype=torch.int64, device=lane_agg.sum.device)
        unperm = lambda x: x[inv_d]

    l_sum, l_cnt = rs(lane_agg.sum), rs(lane_agg.count)
    l_min, l_max, l_last = rs(lane_agg.min), rs(lane_agg.max), rs(lane_agg.last)
    s_err = rs(lane_agg.err).any(dim=1)
    if precise:
        sp_hi, sp_lo = pr.compensated_sum(l_sum, dim=1)
        s_sum = sp_hi + sp_lo
    else:
        s_sum = _chunk_order_sum(lane_agg.sum, s, c, lane_order)
    s_count = l_cnt.sum(dim=1, dtype=torch.int32)
    s_min = l_min.amin(dim=1)
    s_max = l_max.amax(dim=1)
    # last = value of the last chunk that saw any valid record
    cidx = torch.arange(c, device=l_cnt.device)[None, :]
    last_c = torch.where(l_cnt > 0, cidx, -1).amax(dim=1)
    s_last = torch.gather(l_last, 1, last_c.clamp(min=0)[:, None])[:, 0]
    s_last = torch.where(last_c >= 0, s_last, torch.nan)

    has = s_count > 0
    zero = torch.zeros((), dtype=torch.float32, device=s_sum.device)
    if precise:
        t_hi = pr.compensated_sum(torch.where(has, sp_hi, zero)[None, :], dim=1)
        t_lo = pr.compensated_sum(torch.where(has, sp_lo, zero)[None, :], dim=1)
        t_pair = pr.dd_add((t_hi[0][0], t_hi[1][0]), (t_lo[0][0], t_lo[1][0]))
        t_sum = t_pair[0] + t_pair[1]
    else:
        t_sum = torch.where(has, s_sum, zero).sum()
    t_sum, t_count, t_min, t_max = _mesh_totals(
        mesh, t_sum, s_count.sum(dtype=torch.int64), torch.where(has, s_min, torch.inf).amin(),
        torch.where(has, s_max, -torch.inf).amax())
    return ScanAggregates(
        series_sum=unperm(s_sum),
        series_count=unperm(s_count),
        series_min=unperm(torch.where(has, s_min, torch.nan)),
        series_max=unperm(torch.where(has, s_max, torch.nan)),
        series_last=unperm(s_last),
        total_sum=t_sum,
        total_count=t_count,
        total_min=t_min,
        total_max=t_max,
        series_err=unperm(s_err),
    )


def _aggregate_decoded(vals: torch.Tensor, valid: torch.Tensor, mesh=None) -> ScanAggregates:
    """Per-series + cross-series reductions over decoded [S, T] f32 values
    (m3_tpu/parallel/scan.py _aggregate_decoded); ``mesh``: the totals are
    all-reduced over it."""
    zero = torch.where(valid, vals, 0.0)
    s_sum = zero.sum(dim=1)
    s_count = valid.sum(dim=1, dtype=torch.int32)
    s_min = torch.where(valid, vals, torch.inf).amin(dim=1)
    s_max = torch.where(valid, vals, -torch.inf).amax(dim=1)
    t = vals.shape[1]
    last_idx = torch.where(valid, torch.arange(t, device=vals.device)[None, :], -1).amax(dim=1)
    s_last = torch.gather(zero, 1, last_idx.clamp(min=0)[:, None])[:, 0]
    s_last = torch.where(last_idx >= 0, s_last, torch.nan)
    has = s_count > 0
    t_sum, t_count, t_min, t_max = _mesh_totals(
        mesh, torch.where(has, s_sum, 0.0).sum(), s_count.sum(dtype=torch.int64),
        torch.where(has, s_min, torch.inf).amin(), torch.where(has, s_max, -torch.inf).amax())
    return ScanAggregates(
        series_sum=s_sum,
        series_count=s_count,
        series_min=torch.where(has, s_min, torch.nan),
        series_max=torch.where(has, s_max, torch.nan),
        series_last=s_last,
        total_sum=t_sum,
        total_count=t_count,
        total_min=t_min,
        total_max=t_max,
    )


def records_f32(res: D.DecodeResult) -> torch.Tensor:
    """The decoded records' approximate f32 values, NaN where invalid (the
    reference's ``values_f32``: float points by u64.f64_bits_to_f32, int
    points by _int_val_to_f32, its formulas)."""
    return D.record_values_f32(res.bits, res.point_is_float, res.mult, res.valid)


def chunked_scan_aggregate(packed: fused.PackedLanes, s: int, c: int, k: int,
                           mesh=None) -> ScanAggregates:
    """Records decode (kernel R) of series-major packed lanes
    (``fused.pack_lanes(order="s")``) + per-series and cross-series
    reductions of their f32 values (m3_tpu/parallel/scan.py
    chunked_scan_aggregate). ``series_err`` flags series a lane of which
    bailed. ``mesh``: the totals are all-reduced over it."""
    from ..ops import chunked

    if packed.order != "s" or packed.n != s * c:
        raise ValueError(f"want {s * c} series-major lanes, got {packed.n} in order {packed.order!r}")
    args = (packed.windows, packed.lanes, packed.n, k)
    with chunked.PROFILER.dispatch((tuple(packed.windows.shape), int(k)),
                                   cost=(chunked.decode_records_cost, args, {})) as d:
        res = d.done(chunked.decode_chunked_lanes(*args))
    vals = records_f32(res).reshape(s, c * k)
    aggs = _aggregate_decoded(vals, res.valid.reshape(s, c * k), mesh)
    return aggs._replace(series_err=res.err.reshape(s, c).any(dim=1))


def _local_scan_aggregate(words, num_bits, initial_unit, max_points: int,
                          mesh=None) -> ScanAggregates:
    """The whole-stream decode (kernel B-6) of every series, one
    ``m3tsz_decode`` dispatch, then the reductions of its f32 values;
    ``series_err`` flags the series whose decode bailed."""
    args = (words, num_bits, initial_unit, max_points)
    with _JIT_DECODE.dispatch((tuple(words.shape), int(max_points)),
                              cost=(D.decode_batched_cost, args, {})) as d:
        res = d.done(D.decode_batched(*args))
    return _aggregate_decoded(res.values_f32, res.valid, mesh)._replace(series_err=res.err)


def scan_aggregate(words, num_bits, initial_unit, max_points: int) -> ScanAggregates:
    """Single-device whole-stream decode + aggregate (m3_tpu/parallel/
    scan.py:136 scan_aggregate) over ``ops/decode.batched_device_args``'
    tensors."""
    return _local_scan_aggregate(words, num_bits, initial_unit, max_points)


def make_sharded_chunked_scan(mesh, s: int, c: int, k: int):
    """The chunked scan over ``mesh``: returns ``fn(packed)`` that takes
    this rank's series-major packed lanes (``fused.pack_lanes(order="s")``
    of its s / size series, the rows ``series_sharding(mesh)`` gives) and
    returns its per-series arrays and the totals all-reduced over the mesh
    (m3_tpu/parallel/scan.py:370)."""
    if s % mesh.size != 0:
        raise ValueError(f"series count {s} not divisible by mesh size {mesh.size}")
    s_local = s // mesh.size
    return lambda packed: chunked_scan_aggregate(packed, s_local, c, k, mesh=mesh)


def make_sharded_scan(mesh, max_points: int):
    """The whole-stream scan over ``mesh``: returns ``fn(words, num_bits,
    initial_unit)`` over this rank's series (pad with num_bits == 0 series
    to a multiple of the mesh size: they decode no record and drop out of
    every reduction) that returns its per-series arrays and the totals
    all-reduced over the mesh (m3_tpu/parallel/scan.py:404)."""
    return lambda words, num_bits, initial_unit: _local_scan_aggregate(
        words, num_bits, initial_unit, max_points, mesh=mesh)


def sharded_scan_aggregate(words, num_bits, initial_unit, max_points: int,
                           mesh=None) -> ScanAggregates:
    """``make_sharded_scan(mesh, max_points)`` over this rank's series;
    ``mesh`` defaults to ``series_mesh()`` of the initialised process
    group (it raises when there is none)."""
    mesh = series_mesh() if mesh is None else mesh
    return make_sharded_scan(mesh, max_points)(words, num_bits, initial_unit)


def chunked_scan_aggregate_packed(
    packed: fused.PackedLanes, s: int, c: int, k: int, precise: bool = False,
) -> ScanAggregates:
    """The main path: lane kernel B1 over ``packed`` (from fused.pack_lanes,
    on the device it was packed for) + per-series and cross-series
    reductions. Lane order and ``inv`` come from ``packed``. One
    ``packed_lane_agg`` dispatch."""
    with fused.PROFILER_PACKED.dispatch(
        (tuple(packed.windows.shape), int(packed.n), int(k))
    ) as d:
        return d.done(_scan_packed(packed, s, c, k, precise))


def _scan_packed(packed: fused.PackedLanes, s: int, c: int, k: int,
                 precise: bool = False, mesh=None) -> ScanAggregates:
    """``chunked_scan_aggregate_packed``'s body, unprofiled (the resident
    scan runs it inside its own dispatch)."""
    if packed.n != s * c:
        raise ValueError(f"packed holds {packed.n} lanes, want s*c = {s * c}")
    lane_agg = fused.lane_aggregates(
        packed.windows, packed.lanes, packed.tile_flags, n=packed.n, k=k
    )
    return _aggregates_from_lanes(
        lane_agg, s, c, lane_order=packed.order, inv=packed.inv,
        precise=precise, mesh=mesh,
    )


def stitch_host_errors(aggs: ScanAggregates, stream_for) -> ScanAggregates:
    """Recompute series whose device decode bailed (annotations and other
    host-only features set err) with the host codec, and rebuild the totals
    from the patched per-series arrays in float64. Returns numpy arrays.

    ``stream_for(series_idx) -> bytes`` returns the series' encoded stream."""
    from ..codec.m3tsz import decode

    if aggs.series_err is None:
        return aggs
    err = aggs.series_err.cpu().numpy().astype(bool)
    idxs = np.nonzero(err)[0]
    if idxs.size == 0:
        return aggs
    host = lambda x: x.cpu().numpy().copy()
    s_sum, s_cnt = host(aggs.series_sum), host(aggs.series_count)
    s_min, s_max, s_last = host(aggs.series_min), host(aggs.series_max), host(aggs.series_last)
    for i in idxs:
        dps = decode(stream_for(int(i)))
        if not dps:
            s_sum[i] = 0.0
            s_cnt[i] = 0
            s_min[i] = s_max[i] = s_last[i] = np.nan
            continue
        vals32 = np.asarray([dp.value for dp in dps], np.float32)
        s_sum[i] = np.float32(np.sum(vals32.astype(np.float64)))
        s_cnt[i] = len(vals32)
        s_min[i] = vals32.min()
        s_max[i] = vals32.max()
        s_last[i] = vals32[-1]
    has = s_cnt > 0
    return ScanAggregates(
        series_sum=s_sum,
        series_count=s_cnt,
        series_min=s_min,
        series_max=s_max,
        series_last=s_last,
        total_sum=np.float32(np.sum(s_sum[has].astype(np.float64))),
        total_count=int(s_cnt.sum()),
        total_min=np.float32(np.min(s_min[has])) if has.any() else np.float32(np.nan),
        total_max=np.float32(np.max(s_max[has])) if has.any() else np.float32(np.nan),
        series_err=np.zeros_like(err),
    )


def chunked_scan_aggregate_fused(lane_args: dict, s: int, c: int, k: int) -> ScanAggregates:
    """Scan-and-aggregate over the per-field layout (series-major lanes,
    ``ops/chunked.lane_kwargs`` names): kernel B3
    (``fused.lane_aggregates_fields``) folds each lane, then the per-series
    and cross-series reductions. The device is the tensors' own (the JAX
    ``backend=`` switch has no counterpart; the dispatch key carries the
    device type in its place). One ``fused_lane_agg`` dispatch."""
    windows = lane_args["windows"]
    with fused.PROFILER_FUSED.dispatch(
        (windows.device.type, tuple(windows.shape), int(k))
    ) as d:
        lane_agg = d.done(fused.lane_aggregates_fields(**lane_args, k=k))
    return _aggregates_from_lanes(lane_agg, s, c, lane_order="s")


def chunked_device_args(batch, device="cuda") -> dict:
    """ChunkedBatch -> B3's per-field inputs on ``device``: int32 tensors of
    u32 bit patterns, (hi, lo) pairs of them, bool ``first``/``is_float``."""
    from .. import resolve_device
    from ..ops.chunked import lane_kwargs

    dev = resolve_device(device)

    def put(x):
        x = np.asarray(x)
        if x.dtype != np.bool_:
            x = x.astype(np.uint32 if x.dtype == np.uint32 else np.int32, copy=False).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return lane_kwargs(batch, transform=put)


# ---------------------------------------------------------------------------
# Decode from residency: lane assembly by device gathers over the resident
# pool's page buffer and side planes (m3_tpu_torch/resident/pool.py)
# ---------------------------------------------------------------------------
#
# A scan's plan hands over O(series) host int vectors; the lanes' windows,
# rel_pos/num_bits, decoder-state carries and fast-chunk flags are gathered
# on the device from the pool, with no host rebuild of chunk tables and no
# upload of stream bytes. Every array equals what the host packers give for
# the same streams (ops/chunked.assemble_chunked, fused.pack_lanes), so the
# kernels' results are bit-identical to the streamed path's. Lanes are
# assembled in blocks, so the [N, CW] index temporaries stay bounded (at 31.5M
# lanes x 24 words one int64 temporary would be 6 GB).

# lanes per block of the assembly (a multiple of every tile size)
_GATHER_BLOCK_LANES = 1 << 21

# Launches of B-2, counted by _launch_assembly where it launches.
ASSEMBLY_LAUNCHES = 0

# dispatch observability for decode from residency: the assembly entries
# below and the resident scan and fetch (resident/scan.py) dispatch
# through it
RESIDENT_CHUNKED_PROF = KernelProfiler("resident_chunked_assemble")

# Series B-2 sent by its direct route (a stream longer than the slot a block
# gives a series), counted beside ASSEMBLY_LAUNCHES.
ASSEMBLY_DIRECT_SERIES = 0

# lanes of a block of B-2 in the per-field layout (no tiles there)
_FIELD_BLOCK_LANES = 4096


def pad_chunked_plan(plan, s_pad: int):
    """Zero-pad a ResidentChunkedPlan's host vectors to ``s_pad`` series:
    (page_rows, side_rows, n_chunks, total_bits, block_hi, block_lo). Padding
    series point at the zero pages and have no chunks."""
    s = plan.page_rows.shape[0]
    if s_pad == s:
        return (plan.page_rows, plan.side_rows, plan.n_chunks, plan.total_bits,
                plan.block_hi, plan.block_lo)

    def pad(x):
        out = np.zeros((s_pad,) + x.shape[1:], x.dtype)
        out[:s] = x
        return out

    return tuple(pad(x) for x in (plan.page_rows, plan.side_rows, plan.n_chunks,
                                  plan.total_bits, plan.block_hi, plan.block_lo))


class _PlanOnDevice:
    """A padded plan's vectors on the pool's device, and the flat views of
    the two buffers the gathers index."""

    def __init__(self, words, side, vecs: list, c: int, cw: int, w: int, spc: int):
        """``vecs``: plan_vectors' six int32 tensors on the device."""
        pr, sr, nc, tb, bh, bl = vecs
        self.s = nc.shape[0]
        self.lp, self.sl = pr.shape[1], sr.shape[1]
        self.page_rows = pr.reshape(-1)
        self.side_rows = sr.reshape(-1)
        self.n_chunks = nc
        self.total_bits = tb.to(torch.int64)
        self.block = (bh.to(torch.int64) & 0xFFFFFFFF, bl.to(torch.int64) & 0xFFFFFFFF)
        self.words = words.reshape(-1)
        self.side = side.reshape(-1, side.shape[-1])
        # flat word index page * W + word: int32 while it fits
        self.idx_dtype = torch.int32 if self.words.numel() < 2**31 else torch.int64
        self.c, self.cw = c, cw
        self.w, self.spc = w, spc

    @classmethod
    def of_plan(cls, plan, s_pad: int) -> "_PlanOnDevice":
        return cls(plan.words, plan.side, plan_vectors(plan, s_pad), plan.num_chunks,
                   plan.window_words, plan.page_words, plan.side_page_chunks)


def _resident_gather(pd: _PlanOnDevice, si, ci):
    """(si, ci) int32 lane -> (series, chunk) coordinates -> (planes,
    windows int32 [n, CW], rel, nbits, valid). ``planes`` are the decoder
    state unpacked from the packed side rows (ops/sideplane.py, prev_time
    re-based on the series' block_start) as u32 words held in int64. A lane
    whose chunk the series does not have is invalid: zero windows, zero
    state, rel and nbits 0, as the host packer's padding lanes."""
    from ..ops.sideplane import unpack_side_planes

    valid = ci < pd.n_chunks[si]
    ci_v = torch.where(valid, ci, 0)
    # chunk ci sits at slot ci % spc of the series' side page ci // spc;
    # invalid lanes read the reserved zero side page
    sp = pd.side_rows[si * pd.sl + ci_v // pd.spc]
    slot = torch.where(valid, sp * pd.spc + ci_v % pd.spc, 0)
    block = (pd.block[0][si], pd.block[1][si])
    planes = unpack_side_planes(pd.side[slot], block, valid)
    off = planes["off"]
    w0 = (off >> 5).to(torch.int32)
    rel = (off & 31).to(torch.int32)
    nbits = torch.where(valid, (pd.total_bits[si] - (off >> 5) * 32).clamp(0, pd.cw * 32), 0)
    # windows: word position -> page (page_rows), then page * W + word into
    # the flat pool; the plan's trailing zero-page columns keep w0 + cw - 1
    # in range and read zeros
    idt = pd.idx_dtype
    wabs = w0[:, None] + torch.arange(pd.cw, dtype=torch.int32, device=w0.device)[None, :]
    page = pd.page_rows[si[:, None] * pd.lp + wabs // pd.w].to(idt)
    windows = pd.words[page * pd.w + (wabs % pd.w).to(idt)]
    windows = torch.where(valid[:, None], windows, 0)
    return planes, windows, rel, nbits.to(torch.int32), valid


def _u32_plane(name: str, planes, rel, nbits, first):
    """One of fused.PACKED_LANE_PLANES as int32 holding u32 bits."""
    if name == "rel_pos":
        return rel
    if name == "num_bits":
        return nbits
    if name == "first":
        return first.to(torch.int32)
    if name.endswith("_hi"):
        x = planes[name[:-3]][0]
    elif name.endswith("_lo"):
        x = planes[name[:-3]][1]
    else:
        x = planes[name]
    return D.wrap_i32(x).to(torch.int32)


def plan_vectors(plan, s_pad: int) -> list:
    """The padded plan's six vectors as int32 tensors on the pool's device,
    B-2's inputs beside the two buffers: page_rows [S, LP], side_rows
    [S, SL], n_chunks, total_bits, block_hi, block_lo [S]."""
    return _vectors_on(plan.words.device, pad_chunked_plan(plan, s_pad))


def _vectors_on(device, vecs) -> list:
    """``pad_chunked_plan``'s six host vectors as int32 tensors on ``device``."""
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)
    pr_, sr, nc, tb, bh, bl = vecs
    return [put(x) for x in (pr_, sr, nc, np.asarray(tb).astype(np.int32), bh, bl)]


def assembly_slot(plan, cap: int) -> tuple[int, int]:
    """(slot words, direct series) of a B-2 launch over ``plan``: a series'
    span is the stream words its windows lie in, ceil(total_bits / 32) + CW
    (within its page row); the slot is the plan's longest span, at most
    ``cap`` (what a block's shared memory holds beside the side rows, 0 when
    nothing fits), and a series with chunks whose span exceeds the slot
    takes B-2's direct route."""
    return _slot(plan.total_bits, plan.n_chunks, plan.page_rows.shape[1] * plan.page_words,
                 plan.window_words, cap)


def _slot(total_bits: np.ndarray, n_chunks: np.ndarray, row: int, cw: int,
          cap: int) -> tuple[int, int]:
    """assembly_slot over host vectors; ``row`` the words of a page row."""
    top = min((max(int(total_bits.max(initial=0)), 0) + 31) // 32 + cw, row)
    slot = min(top, cap)
    if slot == top:  # every span fits: one reduction over the plan, not an array pass
        return slot, 0
    tb = np.maximum(total_bits.astype(np.int64), 0)
    span = np.minimum((tb + 31) // 32 + cw, row)[n_chunks > 0]
    return slot, int((span > slot).sum())


def _launch_assembly(plan, s_pad: int, order: str, lane_major: bool, tile_lanes: int,
                     vecs: list | None = None, slot: int | None = None):
    """B-2 on the card: (windows int32 [CW, npad] word-major or [n, CW]
    lane-major, planes int32 [NLANE, npad] in PACKED_LANE_PLANES order, tile
    flags int32 [npad // tile_lanes] or None, n). ``vecs``: plan_vectors
    of the same plan and s_pad, when the caller has them. ``slot`` caps the
    stream words a staged series may take below assembly_slot's choice
    (tests send series down the direct route with it). Raises if the build
    or the launch fails."""
    from ..ops._build import load_library

    vecs = plan_vectors(plan, s_pad) if vecs is None else vecs
    c, cw = plan.num_chunks, plan.window_words
    cap = load_library("resident_assembly").m3_resident_assembly_slot_words(c, cw)
    slot_direct = assembly_slot(plan, cap if slot is None else min(slot, cap))
    return _launch_vecs(plan.words, plan.side, vecs, c, cw, plan.page_words,
                        plan.side_page_chunks, order, lane_major, tile_lanes, *slot_direct)


def _launch_vecs(words, side, vecs: list, c: int, cw: int, page_words: int, spc: int,
                 order: str, lane_major: bool, tile_lanes: int, slot: int, direct: int):
    """B-2's launch over plan vectors already on the card (series count
    ``vecs[2].shape[0]``), with its slot and direct-route count given."""
    global ASSEMBLY_LAUNCHES, ASSEMBLY_DIRECT_SERIES
    from ..ops._build import launch_error, load_library

    dev = words.device
    words = words.contiguous()
    side = side.contiguous()
    s_pad = vecs[2].shape[0]
    n = s_pad * c
    npad = n if lane_major else -(-n // tile_lanes) * tile_lanes
    windows = torch.empty((npad, cw) if lane_major else (cw, npad), dtype=torch.int32, device=dev)
    planes = torch.empty((fused.NLANE, npad), dtype=torch.int32, device=dev)
    tile_flags = (None if lane_major else
                  torch.empty(npad // tile_lanes, dtype=torch.int32, device=dev))
    lib = load_library("resident_assembly")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_resident_assembly(
            ptr(words), ptr(side), *[ptr(v) for v in vecs],
            s_pad, c, vecs[0].shape[1], vecs[1].shape[1], page_words, spc, cw,
            0 if order == "c" else 1, int(lane_major), npad, tile_lanes, slot,
            ptr(windows), ptr(planes), ptr(tile_flags), ctypes.c_void_p(stream),
        )
    if rc != 0:
        names = ("page_rows", "side_rows", "n_chunks", "total_bits", "block_hi", "block_lo")
        raise launch_error("resident_assembly", rc, words=words, side=side,
                           **dict(zip(names, vecs)), windows=windows, planes=planes,
                           tile_flags=tile_flags)
    ASSEMBLY_LAUNCHES += 1
    ASSEMBLY_DIRECT_SERIES += direct
    return windows, planes, tile_flags, n


class LaneRows(NamedTuple):
    """B-2's inputs as a table of lane rows held on the pool's device: the
    query plan's per-(doc, block) rows, built once per plan and gathered by
    row on every execution (``assemble_lane_rows``). ``vecs`` are
    plan_vectors' six int32 tensors ([R, LP], [R, SL], then [R] four times);
    ``total_bits`` and ``n_chunks`` their host copies, which fix B-2's slot
    and direct-route count over all R rows once."""

    vecs: list
    total_bits: np.ndarray
    n_chunks: np.ndarray
    num_chunks: int  # C = the most chunks of any row
    window_words: int
    page_words: int
    side_page_chunks: int


def assemble_lane_rows(words, side, table: LaneRows, rows: torch.Tensor | None = None,
                       tile_rows: int = fused.ROWS_DEFAULT, order: str = "s"
                       ) -> fused.PackedLanes:
    """The packed lanes of ``table``'s rows ``rows`` (an int64 tensor on the
    pool's device, one series a row; None: every row) over the pool buffers
    ``words`` and ``side``, in series-major ("s": kernel R's input) or
    chunk-major ("c": B1's) lane order, with no host read: a pool on the
    card launches B-2 over the gathered rows, one on the CPU runs its twin.
    The slot is the table's longest span (at most what a block holds), and
    the direct-route count counts the table's rows past it, an upper bound
    of the gathered rows'."""
    vecs = table.vecs if rows is None else [v.index_select(0, rows) for v in table.vecs]
    c, cw, w, spc = (table.num_chunks, table.window_words, table.page_words,
                     table.side_page_chunks)
    if words.device.type == "cuda":
        from ..ops._build import load_library

        cap = load_library("resident_assembly").m3_resident_assembly_slot_words(c, cw)
        slot_direct = _slot(table.total_bits, table.n_chunks, vecs[0].shape[1] * w, cw, cap)
        windows, planes, tile_flags, n = _launch_vecs(words, side, vecs, c, cw, w, spc, order,
                                                      False, tile_rows * 128, *slot_direct)
        return fused.PackedLanes(windows=windows, lanes=planes, tile_flags=tile_flags, n=n,
                                 order=order)
    return _packed_reference(_PlanOnDevice(words, side, vecs, c, cw, w, spc), order, tile_rows)


def _lane_fields(windows, planes) -> dict:
    """B-2's per-field output as ``assemble_resident_lanes`` returns it:
    row views of the [NLANE, n] planes, bool ``first``/``is_float``."""
    out = {"windows": windows}
    for p, name in enumerate(fused.PACKED_LANE_PLANES):
        if name.endswith(("_hi", "_lo")):
            pair = out.setdefault(name[:-3], [None, None])
            pair[0 if name.endswith("_hi") else 1] = planes[p]
        elif name in ("first", "is_float"):
            out[name] = planes[p] != 0
        else:
            out[name] = planes[p]
    for f in ("prev_time", "prev_delta", "prev_float_bits", "prev_xor", "int_val"):
        out[f] = tuple(out[f])
    return out


def assemble_resident_lanes(plan, s_pad: int | None = None) -> tuple[dict, int]:
    """A ResidentChunkedPlan -> (per-field lane inputs on the pool's device,
    padded series count): series-major lanes (lane = series * C + chunk) in
    ``ops/chunked.lane_kwargs``' names and the types ``chunked_device_args``
    gives, B3's input. ``s_pad`` pads the series axis with empty series. A
    pool on the card launches B-2; one on the CPU runs the twin."""
    s = plan.page_rows.shape[0]
    s_pad = s if s_pad is None else max(s_pad, s)
    with RESIDENT_CHUNKED_PROF.dispatch((s_pad, plan.num_chunks, plan.window_words)) as d:
        if plan.words.device.type == "cuda":
            windows, planes, _, _ = _launch_assembly(plan, s_pad, "s", True, _FIELD_BLOCK_LANES)
            return d.done(_lane_fields(windows, planes)), s_pad
        return d.done(assemble_resident_lanes_reference(plan, s_pad)[0]), s_pad


def assemble_resident_lanes_reference(plan, s_pad: int | None = None) -> tuple[dict, int]:
    """Plain torch twin of B-2's per-field layout, on the pool's device."""
    s = plan.page_rows.shape[0]
    s_pad = s if s_pad is None else max(s_pad, s)
    pd = _PlanOnDevice.of_plan(plan, s_pad)
    dev = pd.words.device
    n = s_pad * pd.c
    i32 = dict(dtype=torch.int32, device=dev)
    out = dict(
        windows=torch.empty((n, pd.cw), **i32),
        rel_pos=torch.empty(n, **i32),
        num_bits=torch.empty(n, **i32),
        first=torch.empty(n, dtype=torch.bool, device=dev),
        time_unit=torch.empty(n, **i32),
        sig=torch.empty(n, **i32),
        mult=torch.empty(n, **i32),
        is_float=torch.empty(n, dtype=torch.bool, device=dev),
    )
    for f in ("prev_time", "prev_delta", "prev_float_bits", "prev_xor", "int_val"):
        out[f] = (torch.empty(n, **i32), torch.empty(n, **i32))
    for start in range(0, n, _GATHER_BLOCK_LANES):
        stop = min(start + _GATHER_BLOCK_LANES, n)
        lane = torch.arange(start, stop, **i32)
        si, ci = lane // pd.c, lane % pd.c
        planes, windows, rel, nbits, valid = _resident_gather(pd, si, ci)
        rows = slice(start, stop)
        out["windows"][rows] = windows
        out["rel_pos"][rows] = rel
        out["num_bits"][rows] = nbits
        out["first"][rows] = valid & (ci == 0)
        out["is_float"][rows] = planes["is_float"] != 0
        for f in ("time_unit", "sig", "mult"):
            out[f][rows] = planes[f].to(torch.int32)
        for f in ("prev_time", "prev_delta", "prev_float_bits", "prev_xor", "int_val"):
            out[f][0][rows] = D.wrap_i32(planes[f][0]).to(torch.int32)
            out[f][1][rows] = D.wrap_i32(planes[f][1]).to(torch.int32)
    return out, s_pad


def assemble_resident_packed(plan, s_pad: int | None = None, order: str = "c",
                             rows: int = fused.ROWS_DEFAULT) -> tuple[fused.PackedLanes, int]:
    """A ResidentChunkedPlan -> (fused.PackedLanes on the pool's device,
    padded series count): the word-major layout of ``fused.pack_lanes``, in
    chunk-major ("c": B1's input) or series-major ("s": kernel R's) lane
    order. Windows, state planes and tile flags are bit-identical to
    ``fused.pack_lanes`` of the same streams: lane j of "c" is (series
    j % S, chunk j // S), tile-padding lanes are zero and count as fast,
    first chunks are never fast. A pool on the card launches B-2; one on the
    CPU runs the twin. One ``resident_chunked_assemble`` dispatch."""
    s = plan.page_rows.shape[0]
    s_pad = s if s_pad is None else max(s_pad, s)
    key = ("packed", s_pad, plan.num_chunks, plan.window_words, order)
    with RESIDENT_CHUNKED_PROF.dispatch(key) as d:
        return d.done(_assemble_packed(plan, s_pad, order, rows)), s_pad


def _assemble_packed(plan, s_pad: int, order: str, rows: int) -> fused.PackedLanes:
    """``assemble_resident_packed``'s body, unprofiled (the resident scan
    runs it inside its own dispatch)."""
    if order not in ("c", "s"):
        raise ValueError(f"order must be 'c' or 's', got {order!r}")
    if plan.words.device.type == "cuda":
        windows, planes, tile_flags, n = _launch_assembly(plan, s_pad, order, False, rows * 128)
        return fused.PackedLanes(windows=windows, lanes=planes, tile_flags=tile_flags, n=n,
                                 order=order)
    return assemble_resident_packed_reference(plan, s_pad, order, rows)[0]


def assemble_resident_packed_reference(plan, s_pad: int | None = None, order: str = "c",
                                       rows: int = fused.ROWS_DEFAULT
                                       ) -> tuple[fused.PackedLanes, int]:
    """Plain torch twin of B-2's packed layout, on the pool's device."""
    if order not in ("c", "s"):
        raise ValueError(f"order must be 'c' or 's', got {order!r}")
    s = plan.page_rows.shape[0]
    s_pad = s if s_pad is None else max(s_pad, s)
    return _packed_reference(_PlanOnDevice.of_plan(plan, s_pad), order, rows), s_pad


def _packed_reference(pd: _PlanOnDevice, order: str, rows: int) -> fused.PackedLanes:
    """The packed layout's twin over a plan on the device."""
    s_pad = pd.s
    dev = pd.words.device
    n = s_pad * pd.c
    tile_lanes = rows * 128
    tiles = -(-n // tile_lanes)
    npad = tiles * tile_lanes
    windows = torch.empty((pd.cw, npad), dtype=torch.int32, device=dev)
    lanes = torch.empty((fused.NLANE, npad), dtype=torch.int32, device=dev)
    int_tiles = torch.empty(tiles, dtype=torch.bool, device=dev)
    flt_tiles = torch.empty(tiles, dtype=torch.bool, device=dev)
    block = max(tile_lanes, _GATHER_BLOCK_LANES // tile_lanes * tile_lanes)
    for start in range(0, npad, block):
        stop = min(start + block, npad)
        j = torch.arange(start, stop, dtype=torch.int32, device=dev)
        inb = j < n
        if order == "c":
            si, ci = torch.where(inb, j % s_pad, 0), torch.where(inb, j // s_pad, pd.c)
        else:
            si, ci = torch.where(inb, j // pd.c, 0), torch.where(inb, j % pd.c, pd.c)
        planes, win, rel, nbits, valid = _resident_gather(pd, si, ci)
        windows[:, start:stop] = win.T
        first = valid & (ci == 0)
        for p, name in enumerate(fused.PACKED_LANE_PLANES):
            lanes[p, start:stop] = _u32_plane(name, planes, rel, nbits, first)
        # tile class from the fast-chunk flags (side word 8): padding and
        # invalid lanes never force a tile slow, first chunks always do
        flags = planes["flags"]
        not_first = ci != 0
        fast_i = torch.where(valid, ((flags & 1) != 0) & not_first, True)
        fast_f = torch.where(valid, ((flags & 2) != 0) & not_first, True)
        t = slice(start // tile_lanes, stop // tile_lanes)
        int_tiles[t] = fast_i.reshape(-1, tile_lanes).all(dim=1)
        flt_tiles[t] = fast_f.reshape(-1, tile_lanes).all(dim=1)
    tile_flags = torch.where(int_tiles, 1, torch.where(flt_tiles, 2, 0)).to(torch.int32)
    return fused.PackedLanes(windows=windows, lanes=lanes, tile_flags=tile_flags, n=n,
                             order=order)


def make_sharded_resident_chunked_scan(mesh, c: int, k: int, cw: int, w: int, spc: int):
    """The decode-from-residency scan (m3_tpu/parallel/scan.py:700 and
    resident_chunked_local_fn): returns ``fn(pool_words, side_words,
    page_rows, side_rows, n_chunks, total_bits, block_hi, block_lo)`` over
    the pool buffers and the whole padded plan vectors
    (``pad_chunked_plan``, numpy). ``mesh`` None: the whole series range on
    one device. Else every rank holds the same pool buffers (the reference
    replicates them), takes its slice of the vectors' series, and the totals
    are all-reduced over the mesh. The rows' chunk-major lanes are assembled
    from the pool (``assemble_lane_rows``: B-2 on the card, the twin on the
    CPU) and folded by B1; it returns this rank's per-series arrays.
    Unprofiled: the resident scan (resident/scan.py) dispatches it as one
    ``resident_chunked_assemble`` dispatch, as the reference's one program."""

    def local(pool_words, side_words, *vecs):
        rows = slice(None) if mesh is None else series_sharding(mesh).rows(len(vecs[0]))
        vecs = [np.asarray(v)[rows] for v in vecs]
        table = LaneRows(vecs=_vectors_on(pool_words.device, vecs), total_bits=vecs[3],
                         n_chunks=vecs[2], num_chunks=c, window_words=cw, page_words=w,
                         side_page_chunks=spc)
        packed = assemble_lane_rows(pool_words, side_words, table, order="c")
        return _scan_packed(packed, s=vecs[2].shape[0], c=c, k=k, mesh=mesh)

    return local
