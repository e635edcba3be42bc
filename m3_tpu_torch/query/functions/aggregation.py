"""Cross-series (tag-grouped) aggregations as segment reductions.

Port of ``m3_tpu/query/functions/aggregation.py``: ``GroupLayout`` and
``group_by_tags`` are plain copies (grouping happens on the host once per
query). For a CUDA tensor the seven grouped ops run on kernel K3
(``csrc/grouped_reduce.cu``): one thread per (group, column) folds the
group's members in ascending row order, so the result is the same in every
run. For a CPU tensor they run the plain PyTorch twin, ``index_add_`` /
``index_reduce_`` over the series axis, which on the CPU adds in the same
order; K3, the twin and the reference on the CPU agree bit for bit. (On a
CUDA tensor those two calls are atomics whose f32 sums depend on the order
of arrival.) Values are reduced in float32, as the reference's jnp code
reduces them (JAX runs without x64).

NaN semantics (M3's aggregation/function.go):
  sum/min/max: NaN iff every value in the bucket is NaN
  count: number of non-NaN values (0, not NaN, for empty buckets)
  avg/stddev/var: NaN iff count == 0 (population variance)
Signed zeros: min and max order -0 below +0 (XLA's min and max), so a zero
min is -0 when a member is -0 and a zero max is +0 when a member is +0.
``topk``, ``bottomk``, ``quantile`` and ``count_values`` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import device_guard
from ...block.core import SeriesMeta, Tags
from ...ops._build import load_library

# K3's op ids (enum Op of csrc/grouped_reduce.cu)
OPS = ("sum", "count", "avg", "min", "max", "stdvar", "stddev")

# Launches of K3, counted by grouped_reduce where it launches.
LAUNCHES = 0


@dataclass
class GroupLayout:
    """Host-computed series→group assignment.

    group_ids: int32[S] group index per series
    metas: per-group SeriesMeta (the retained tags)
    pad_index: int32[G, M] series indices per group, -1 padded (for sort-based
      ops: quantile/topk), M = max group size
    """

    group_ids: np.ndarray
    metas: list[SeriesMeta]
    pad_index: np.ndarray

    @property
    def num_groups(self) -> int:
        return len(self.metas)


def group_by_tags(
    series: list[SeriesMeta],
    matching: list[bytes] | None = None,
    without: bool = False,
) -> GroupLayout:
    """PromQL by/without grouping (aggregation/function.go:180-210 via
    utils.GroupSeries). matching=None, without=False → one global group."""
    matching = [m if isinstance(m, bytes) else m.encode() for m in (matching or [])]
    groups: dict[Tags, int] = {}
    members: list[list[int]] = []
    metas: list[SeriesMeta] = []
    gids = np.zeros(len(series), np.int32)
    for i, sm in enumerate(series):
        if without:
            key = tuple((k, v) for k, v in sm.tags if k not in matching)
        else:
            key = tuple((k, v) for k, v in sm.tags if k in matching)
        gid = groups.get(key)
        if gid is None:
            gid = len(metas)
            groups[key] = gid
            metas.append(SeriesMeta(tags=key))
            members.append([])
        gids[i] = gid
        members[gid].append(i)
    m = max((len(x) for x in members), default=1)
    pad = np.full((len(metas), m), -1, np.int32)
    for g, idxs in enumerate(members):
        pad[g, : len(idxs)] = idxs
    return GroupLayout(group_ids=gids, metas=metas, pad_index=pad)


def grouped_reduce(values, layout: GroupLayout, op: str):
    """``op`` (one of ``OPS``) of each group's members, per column: f32
    [G, T] on ``values``' device. A CUDA tensor launches K3 (and raises if
    the build or the launch fails); a CPU tensor runs the twin."""
    values = torch.as_tensor(values).to(torch.float32)
    if values.device.type == "cpu":
        return grouped_reduce_reference(values, layout, op)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if values.dim() != 2 or values.shape[0] != len(layout.group_ids):
        raise ValueError(f"want a [S, T] matrix of the layout's {len(layout.group_ids)} series, "
                         f"got shape {tuple(values.shape)}")
    global LAUNCHES
    v = values.contiguous()
    pad = torch.from_numpy(np.ascontiguousarray(layout.pad_index, np.int32)).to(v.device)
    g, m = pad.shape
    out = torch.empty((g, v.shape[1]), dtype=torch.float32, device=v.device)
    if g == 0 or v.shape[1] == 0:
        return out
    lib = load_library("grouped_reduce")
    with device_guard(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.m3_grouped_reduce(v.data_ptr(), v.shape[1], pad.data_ptr(), g, m,
                                   OPS.index(op), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"grouped_reduce kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def grouped_reduce_reference(values, layout: GroupLayout, op: str):
    """Plain PyTorch twin of K3."""
    values = values.to(torch.float32)
    if op in ("min", "max"):
        return _grouped_extreme(values, layout, op)
    if op == "stddev":
        # the correctly rounded root, as K3's __fsqrt_rn and XLA's sqrt
        # give it: torch.sqrt of f32 on the CPU is off by an ulp on some
        # inputs; the f64 root rounded to f32 is exact
        return torch.sqrt(grouped_reduce_reference(values, layout, "stdvar").double()).float()
    s, c, gids, g, valid = _seg(values, layout)
    if op == "count":
        return c
    if op == "sum":
        return torch.where(c > 0, s, torch.nan)
    mean = torch.where(c > 0, s / torch.clamp(c, min=1), torch.nan)
    if op == "avg":
        return mean
    if op != "stdvar":
        raise ValueError(f"unknown grouped op {op!r}")
    # two-pass population variance exactly as varianceFn (function.go:124-143)
    diff = values - mean[gids]
    sq = torch.where(valid, diff * diff, 0.0)
    ss = _seg_sum(sq, gids, g)
    return torch.where(c > 0, ss / torch.clamp(c, min=1), torch.nan)


def _gids(values, layout: GroupLayout):
    return torch.from_numpy(np.asarray(layout.group_ids, np.int64)).to(values.device)


def _seg_sum(x, gids, g):
    return torch.zeros((g,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, gids, x)


def _seg(values, layout: GroupLayout):
    gids = _gids(values, layout)
    g = layout.num_groups
    valid = ~torch.isnan(values)
    x = torch.where(valid, values, 0.0)
    s = _seg_sum(x, gids, g)
    c = _seg_sum(valid.to(values.dtype), gids, g)
    return s, c, gids, g, valid


def _grouped_extreme(values, layout: GroupLayout, op: str):
    gids = _gids(values, layout)
    g = layout.num_groups
    valid = ~torch.isnan(values)
    fill = torch.inf if op == "min" else -torch.inf
    x = torch.where(valid, values, fill)
    m = torch.full((g,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    m.index_reduce_(0, gids, x, "amin" if op == "min" else "amax", include_self=True)
    # index_reduce_ keeps whichever zero comes first; the reference's min
    # (max) is -0 (+0) when a member is -0 (+0)
    sign = torch.signbit(x) if op == "min" else ~torch.signbit(x)
    has_zero = _seg_sum(((x == 0) & sign).to(torch.float32), gids, g) > 0
    m = torch.where((m == 0) & has_zero, -0.0 if op == "min" else 0.0, m)
    c = _seg_sum(valid.to(torch.float32), gids, g)
    return torch.where(c > 0, m, torch.nan)


def grouped_sum(values, layout: GroupLayout):
    return grouped_reduce(values, layout, "sum")


def grouped_count(values, layout: GroupLayout):
    return grouped_reduce(values, layout, "count")


def grouped_avg(values, layout: GroupLayout):
    return grouped_reduce(values, layout, "avg")


def grouped_min(values, layout: GroupLayout):
    return grouped_reduce(values, layout, "min")


def grouped_max(values, layout: GroupLayout):
    return grouped_reduce(values, layout, "max")


def grouped_stdvar(values, layout: GroupLayout):
    return grouped_reduce(values, layout, "stdvar")


def grouped_stddev(values, layout: GroupLayout):
    return grouped_reduce(values, layout, "stddev")
