"""Scan-and-aggregate over chunk-lanes: the port's main path.

Port of ``m3_tpu/parallel/scan.py``'s chunked paths, on one device (the
sharded variants wait for ROADMAP §A8):

- ``chunked_scan_aggregate_packed``: kernel B1 (``ops/fused.lane_aggregates``)
  folds each packed chunk-lane into six aggregates; plain torch reduces
  them per series and across series, as the JAX package leaves those
  reductions to XLA.
- ``chunked_scan_aggregate_fused``: the same over the per-field layout
  with kernel B3 (``ops/fused.lane_aggregates_fields``).
- the resident lane assembly: device gathers over the resident pool's
  pages and side planes build either layout (``assemble_resident_packed``,
  ``assemble_resident_lanes``). For a pool on the card they launch kernel
  B-2 (``csrc/resident_assembly.cu``); for a pool on the CPU they run its
  plain torch twin (``_resident_gather``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import device_guard
from ..ops import decode as D
from ..ops import fused
from ..ops import precise as pr


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


def _aggregates_from_lanes(
    lane_agg: fused.LaneAggregates, s: int, c: int, lane_order: str = "s",
    inv=None, precise: bool = False,
) -> ScanAggregates:
    """Reduce per-lane aggregates [S*C] to ScanAggregates.

    ``lane_order``: "s" series-major (lane = s*C + c), "c" chunk-major
    (lane = c*S + s), "sorted" chunk-major with the series axis permuted;
    ``inv`` (int[S]) gathers per-series outputs back to series order."""
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
        s_sum = l_sum.sum(dim=1)
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
    t_count = s_count.sum(dtype=torch.int64)
    t_min = torch.where(has, s_min, torch.inf).amin()
    t_max = torch.where(has, s_max, -torch.inf).amax()
    t_min = torch.where(t_count > 0, t_min, torch.nan)
    t_max = torch.where(t_count > 0, t_max, torch.nan)
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


def chunked_scan_aggregate_packed(
    packed: fused.PackedLanes, s: int, c: int, k: int, precise: bool = False,
) -> ScanAggregates:
    """The main path: lane kernel over ``packed`` (from fused.pack_lanes,
    on the device it was packed for) + per-series and cross-series
    reductions. Lane order and ``inv`` come from ``packed``."""
    if packed.n != s * c:
        raise ValueError(f"packed holds {packed.n} lanes, want s*c = {s * c}")
    lane_agg = fused.lane_aggregates(
        packed.windows, packed.lanes, packed.tile_flags, n=packed.n, k=k
    )
    return _aggregates_from_lanes(
        lane_agg, s, c, lane_order=packed.order, inv=packed.inv,
        precise=precise,
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
    ``backend=`` switch has no counterpart)."""
    lane_agg = fused.lane_aggregates_fields(**lane_args, k=k)
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

    def __init__(self, plan, s_pad: int):
        dev = plan.words.device
        pr, sr, nc, tb, bh, bl = pad_chunked_plan(plan, s_pad)
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        self.s = s_pad
        self.lp, self.sl = pr.shape[1], sr.shape[1]
        self.page_rows = put(pr.reshape(-1))
        self.side_rows = put(sr.reshape(-1))
        self.n_chunks = put(nc)
        self.total_bits = put(tb.astype(np.int64))
        self.block = (put(bh.astype(np.int64)), put(bl.astype(np.int64)))
        self.words = plan.words.reshape(-1)
        self.side = plan.side.reshape(-1, plan.side.shape[-1])
        # flat word index page * W + word: int32 while it fits
        self.idx_dtype = torch.int32 if self.words.numel() < 2**31 else torch.int64
        self.c, self.cw = plan.num_chunks, plan.window_words
        self.w, self.spc = plan.page_words, plan.side_page_chunks


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
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(plan.words.device)
    pr_, sr, nc, tb, bh, bl = pad_chunked_plan(plan, s_pad)
    return [put(x) for x in (pr_, sr, nc, tb.astype(np.int32), bh, bl)]


def assembly_slot(plan, cap: int) -> tuple[int, int]:
    """(slot words, direct series) of a B-2 launch over ``plan``: a series'
    span is the stream words its windows lie in, ceil(total_bits / 32) + CW
    (within its page row); the slot is the plan's longest span, at most
    ``cap`` (what a block's shared memory holds beside the side rows, 0 when
    nothing fits), and a series with chunks whose span exceeds the slot
    takes B-2's direct route."""
    row = plan.page_rows.shape[1] * plan.page_words
    top = min((max(int(plan.total_bits.max(initial=0)), 0) + 31) // 32 + plan.window_words, row)
    slot = min(top, cap)
    if slot == top:  # every span fits: one reduction over the plan, not an array pass
        return slot, 0
    tb = np.maximum(plan.total_bits.astype(np.int64), 0)
    span = np.minimum((tb + 31) // 32 + plan.window_words, row)[plan.n_chunks > 0]
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
    global ASSEMBLY_LAUNCHES, ASSEMBLY_DIRECT_SERIES
    from ..ops._build import launch_error, load_library

    dev = plan.words.device
    vecs = plan_vectors(plan, s_pad) if vecs is None else vecs
    words = plan.words.contiguous()
    side = plan.side.contiguous()
    c, cw = plan.num_chunks, plan.window_words
    n = s_pad * c
    npad = n if lane_major else -(-n // tile_lanes) * tile_lanes
    windows = torch.empty((npad, cw) if lane_major else (cw, npad), dtype=torch.int32, device=dev)
    planes = torch.empty((fused.NLANE, npad), dtype=torch.int32, device=dev)
    tile_flags = (None if lane_major else
                  torch.empty(npad // tile_lanes, dtype=torch.int32, device=dev))
    lib = load_library("resident_assembly")
    cap = lib.m3_resident_assembly_slot_words(c, cw)
    slot, direct = assembly_slot(plan, cap if slot is None else min(slot, cap))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_resident_assembly(
            ptr(words), ptr(side), *[ptr(v) for v in vecs],
            s_pad, c, vecs[0].shape[1], vecs[1].shape[1], plan.page_words,
            plan.side_page_chunks, cw,
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
    if plan.words.device.type == "cuda":
        windows, planes, _, _ = _launch_assembly(plan, s_pad, "s", True, _FIELD_BLOCK_LANES)
        return _lane_fields(windows, planes), s_pad
    return assemble_resident_lanes_reference(plan, s_pad)


def assemble_resident_lanes_reference(plan, s_pad: int | None = None) -> tuple[dict, int]:
    """Plain torch twin of B-2's per-field layout, on the pool's device."""
    s = plan.page_rows.shape[0]
    s_pad = s if s_pad is None else max(s_pad, s)
    pd = _PlanOnDevice(plan, s_pad)
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
    CPU runs the twin."""
    if order not in ("c", "s"):
        raise ValueError(f"order must be 'c' or 's', got {order!r}")
    s = plan.page_rows.shape[0]
    s_pad = s if s_pad is None else max(s_pad, s)
    if plan.words.device.type == "cuda":
        windows, planes, tile_flags, n = _launch_assembly(plan, s_pad, order, False, rows * 128)
        return fused.PackedLanes(windows=windows, lanes=planes, tile_flags=tile_flags, n=n,
                                 order=order), s_pad
    return assemble_resident_packed_reference(plan, s_pad, order, rows)


def assemble_resident_packed_reference(plan, s_pad: int | None = None, order: str = "c",
                                       rows: int = fused.ROWS_DEFAULT
                                       ) -> tuple[fused.PackedLanes, int]:
    """Plain torch twin of B-2's packed layout, on the pool's device."""
    if order not in ("c", "s"):
        raise ValueError(f"order must be 'c' or 's', got {order!r}")
    s = plan.page_rows.shape[0]
    s_pad = s if s_pad is None else max(s_pad, s)
    pd = _PlanOnDevice(plan, s_pad)
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
                             order=order), s_pad


def resident_chunked_scan(plan, s_pad: int) -> ScanAggregates:
    """The assemble-from-residency + packed-decode body: device gathers over
    the pool build the chunk-major PackedLanes, kernel B1 folds them, the
    reductions follow (m3_tpu/parallel/scan.py resident_chunked_local_fn;
    the sharded variant waits for ROADMAP §A8)."""
    packed, s_pad = assemble_resident_packed(plan, s_pad, order="c")
    return chunked_scan_aggregate_packed(packed, s=s_pad, c=plan.num_chunks, k=plan.chunk_k)
