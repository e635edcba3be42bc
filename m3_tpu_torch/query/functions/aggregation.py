"""Cross-series (tag-grouped) aggregations as segment reductions in torch.

Port of ``m3_tpu/query/functions/aggregation.py``: ``GroupLayout`` and
``group_by_tags`` are plain copies (grouping happens on the host once per
query); the seven grouped ops reduce over the series axis on the values'
device with ``index_add_`` / ``index_reduce_``. Values are reduced in
float32, as the reference's jnp code reduces them (JAX runs without x64).

NaN semantics (M3's aggregation/function.go):
  sum/min/max: NaN iff every value in the bucket is NaN
  count: number of non-NaN values (0, not NaN, for empty buckets)
  avg/stddev/var: NaN iff count == 0 (population variance)
``topk``, ``bottomk``, ``quantile`` and ``count_values`` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...block.core import SeriesMeta, Tags


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


def _gids(values, layout: GroupLayout):
    return torch.from_numpy(np.asarray(layout.group_ids, np.int64)).to(values.device)


def _seg_sum(x, gids, g):
    return torch.zeros((g,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add_(0, gids, x)


def _seg(values, layout: GroupLayout):
    values = values.to(torch.float32)
    gids = _gids(values, layout)
    g = layout.num_groups
    valid = ~torch.isnan(values)
    x = torch.where(valid, values, 0.0)
    s = _seg_sum(x, gids, g)
    c = _seg_sum(valid.to(values.dtype), gids, g)
    return s, c, gids, g, valid, values


def grouped_sum(values, layout: GroupLayout):
    s, c, *_ = _seg(values, layout)
    return torch.where(c > 0, s, torch.nan)


def grouped_count(values, layout: GroupLayout):
    _, c, *_ = _seg(values, layout)
    return c


def grouped_avg(values, layout: GroupLayout):
    s, c, *_ = _seg(values, layout)
    return torch.where(c > 0, s / torch.clamp(c, min=1), torch.nan)


def _grouped_extreme(values, layout: GroupLayout, reduce: str, fill: float):
    values = values.to(torch.float32)
    gids = _gids(values, layout)
    g = layout.num_groups
    valid = ~torch.isnan(values)
    x = torch.where(valid, values, fill)
    m = torch.full((g,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    m.index_reduce_(0, gids, x, reduce, include_self=True)
    c = _seg_sum(valid.to(torch.float32), gids, g)
    return torch.where(c > 0, m, torch.nan)


def grouped_min(values, layout: GroupLayout):
    return _grouped_extreme(values, layout, "amin", torch.inf)


def grouped_max(values, layout: GroupLayout):
    return _grouped_extreme(values, layout, "amax", -torch.inf)


def grouped_stdvar(values, layout: GroupLayout):
    # two-pass population variance exactly as varianceFn (function.go:124-143)
    s, c, gids, g, valid, values = _seg(values, layout)
    mean = torch.where(c > 0, s / torch.clamp(c, min=1), torch.nan)
    diff = values - mean[gids]
    sq = torch.where(valid, diff * diff, 0.0)
    ss = _seg_sum(sq, gids, g)
    return torch.where(c > 0, ss / torch.clamp(c, min=1), torch.nan)


def grouped_stddev(values, layout: GroupLayout):
    return torch.sqrt(grouped_stdvar(values, layout))
