"""Scan-and-aggregate over packed chunk-lanes: the port's main path.

Port of the packed path of ``m3_tpu/parallel/scan.py``: the lane kernel
(``ops/fused.lane_aggregates``) folds each chunk-lane into six aggregates,
then plain torch reduces them per series (over its chunks) and across
series, as the JAX package leaves those reductions to XLA. One device, no
collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
