"""Cross-series (tag-grouped) aggregations as segment reductions.

Port of ``m3_tpu/query/functions/aggregation.py``: ``GroupLayout`` and
``group_by_tags`` are plain copies (grouping happens on the host once per
query). For a CUDA tensor the seven grouped ops run on kernel K3
(``csrc/grouped_reduce.cu``): one lane per (group, column) folds the
group's members in ascending row order from a ring of member slices in
shared memory, so the result is the same in every run. For a CPU tensor
they run the plain PyTorch twin, the same fold vectorized over (group,
column); K3, the twin and the reference on the CPU
agree bit for bit. Values are reduced in float32, as the reference's jnp
code reduces them (JAX runs without x64), and f32 subnormals flush to zero
of the same sign, inputs and results alike, as XLA flushes them on the CPU
and the TPU.

NaN semantics (M3's aggregation/function.go):
  sum/min/max: NaN iff every value in the bucket is NaN
  count: number of non-NaN values (0, not NaN, for empty buckets)
  avg/stddev/var: NaN iff count == 0 (population variance)
Signed zeros: min and max order -0 below +0 (XLA's min and max), so a zero
min is -0 when a member is -0 and a zero max is +0 when a member is +0.

``absent``, ``grouped_quantile``, ``topk`` / ``bottomk`` (take.go) and
``count_values`` are torch copies of the reference's jnp code, float32 on
the values' device; ``count_values``, whose output cardinality depends on
the data, runs on the host as the reference's does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import device_guard
from ...block.core import SeriesMeta, Tags
from ...ops._build import launch_error, load_library

# K3's op ids (enum Op of csrc/grouped_reduce.cu)
OPS = ("sum", "count", "avg", "min", "max", "stdvar", "stddev")

# Launches of K3, counted by grouped_reduce where it launches.
LAUNCHES = 0

_FLT_MIN = float(np.finfo(np.float32).tiny)


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
    v = values.contiguous()
    pad = torch.from_numpy(np.ascontiguousarray(layout.pad_index, np.int32)).to(v.device)
    return launch_grouped_reduce(v, pad, op)


def launch_grouped_reduce(values, pad, op: str, wc: int = 0):
    """K3 on a contiguous f32 [S, T] CUDA tensor and the layout's pad_index
    already on the card (int32 [G, M]): f32 [G, T]. ``wc`` forces the column
    block's width (8, 16 or 32); 0 lets the kernel pick it by shape."""
    global LAUNCHES
    if (values.dtype != torch.float32 or not values.is_contiguous() or values.dim() != 2
            or pad.dtype != torch.int32 or not pad.is_contiguous() or pad.dim() != 2
            or pad.device != values.device or values.device.type != "cuda"):
        raise ValueError("want contiguous f32 [S, T] values and int32 [G, M] pad_index on one "
                         f"card, got {values.dtype} {tuple(values.shape)} on {values.device} and "
                         f"{pad.dtype} {tuple(pad.shape)} on {pad.device}")
    g, m = pad.shape
    out = torch.empty((g, values.shape[1]), dtype=torch.float32, device=values.device)
    if g == 0 or values.shape[1] == 0:
        return out
    lib = load_library("grouped_reduce")
    with device_guard(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.m3_grouped_reduce(values.data_ptr(), values.shape[0], values.shape[1],
                                   pad.data_ptr(), g, m, OPS.index(op), wc, out.data_ptr(), stream)
    if rc != 0:
        raise launch_error("grouped_reduce", rc, values=values, pad_index=pad, out=out)
    LAUNCHES += 1
    return out


def _ftz(x):
    """Flush f32 subnormals to a zero of the same sign (XLA's FTZ/DAZ)."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def grouped_reduce_reference(values, layout: GroupLayout, op: str):
    """Plain PyTorch twin of K3: the same left fold over each group's
    members in ascending row order, vectorized over (group, column), with
    every input and every arithmetic result flushed to zero when subnormal.
    Holding K3's order also keeps it bit-identical to the reference's XLA
    segment ops on the CPU, which add in row order and flush subnormals."""
    if op not in OPS:
        raise ValueError(f"unknown grouped op {op!r}")
    values = _ftz(values.to(torch.float32))
    pad = torch.from_numpy(np.asarray(layout.pad_index, np.int64)).to(values.device)
    g, m = pad.shape
    shape = (g, values.shape[1])
    zero = torch.zeros(shape, dtype=torch.float32, device=values.device)
    s, c, ss = zero, zero, zero
    ext = torch.full(shape, torch.inf if op == "min" else -torch.inf, device=values.device)
    # a group's members end at its first -1
    members = [(pad[:, j] >= 0)[:, None] for j in range(m)]
    rows = [values[pad[:, j].clamp(min=0)] for j in range(m)]
    for live, x in zip(members, rows):
        nan = torch.isnan(x)
        c = torch.where(live, c + (~nan).to(torch.float32), c)
        if op == "min":
            y = torch.where(nan, torch.inf, x)
            take = (y < ext) | ((y == 0) & (ext == 0) & torch.signbit(y))
            ext = torch.where(live & take, y, ext)
        elif op == "max":
            y = torch.where(nan, -torch.inf, x)
            take = (y > ext) | ((y == 0) & (ext == 0) & ~torch.signbit(y))
            ext = torch.where(live & take, y, ext)
        else:
            s = torch.where(live, _ftz(s + torch.where(nan, 0.0, x)), s)
    has = c > 0
    if op == "count":
        return c
    if op in ("min", "max"):
        return torch.where(has, ext, torch.nan)
    if op == "sum":
        return torch.where(has, s, torch.nan)
    mean = torch.where(has, _ftz(s / torch.clamp(c, min=1)), torch.nan)
    if op == "avg":
        return mean
    # two-pass population variance exactly as varianceFn (function.go:124-143)
    for live, x in zip(members, rows):
        d = _ftz(x - mean)
        sq = _ftz(d * d)
        ss = torch.where(live, _ftz(ss + torch.where(torch.isnan(x), 0.0, sq)), ss)
    var = torch.where(has, _ftz(ss / torch.clamp(c, min=1)), torch.nan)
    if op == "stdvar":
        return var
    # stddev: the correctly rounded root, as K3's __fsqrt_rn and XLA's sqrt
    # give it (torch's f32 sqrt on the CPU is off by an ulp on some inputs;
    # the f64 root rounded to f32 is exact)
    return torch.sqrt(var.double()).float()


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


def absent(values, layout: GroupLayout | None = None):
    """absentFn (function.go:46-55): per step, 1 if no series has a value."""
    v = torch.as_tensor(values)
    any_present = (~torch.isnan(v)).any(dim=0)
    return torch.where(any_present, torch.nan, 1.0).to(torch.float32)[None, :]


def _padded(values, layout: GroupLayout):
    """[G, M, T] group-major f32 view, NaN at padding."""
    v = torch.as_tensor(values).to(torch.float32)
    idx = torch.as_tensor(np.asarray(layout.pad_index, np.int64), device=v.device)
    g = v[idx.clamp(0, v.shape[0] - 1)]
    return torch.where((idx < 0)[:, :, None], torch.nan, g)


def grouped_quantile(values, layout: GroupLayout, q: float):
    """Same interpolation as quantile_over_time (aggregation.go:265-297)."""
    p = _padded(values, layout)  # [G, M, T]
    m = p.shape[1]
    sw = torch.sort(p, dim=1).values  # NaN to the end of axis 1
    n = (~torch.isnan(p)).sum(dim=1)  # [G, T]
    if q < 0 or q > 1:
        return torch.where(n > 0, -torch.inf if q < 0 else torch.inf, torch.nan).to(torch.float32)
    rank = torch.tensor(q, dtype=torch.float32, device=p.device) * (n - 1).to(torch.float32)
    lo = torch.floor(rank).to(torch.int64).clamp(0, m - 1)
    hi = torch.minimum((lo + 1).clamp(0, m - 1), (n - 1).clamp(min=0))
    frac = rank - lo.to(torch.float32)
    vlo = torch.gather(sw, 1, lo[:, None, :])[:, 0, :]
    vhi = torch.gather(sw, 1, hi[:, None, :])[:, 0, :]
    out = vlo + (vhi - vlo) * frac
    return torch.where(n > 0, out, torch.nan)


def _take(values, layout: GroupLayout, k: int, largest: bool):
    """topk/bottomk (take.go): keep k best per group per step, NaN the rest.
    Stable rank (ties broken by series order) like the reference heap."""
    v = torch.as_tensor(values).to(torch.float32)
    p = _padded(v, layout)  # [G, M, T]
    key = torch.where(torch.isnan(p), -torch.inf if largest else torch.inf, p)
    if largest:
        key = -key  # argsort ascending == descending on value
    order = torch.argsort(key, dim=1, stable=True)  # [G, M, T]
    ranks = torch.argsort(order, dim=1, stable=True)  # rank of each slot
    keep_padded = (ranks < k) & ~torch.isnan(p)
    # scatter back to [S, T]: each series sits in one slot; padding slots
    # (clipped to row 0) add nothing, so an int sum is the reference's max
    s, t = v.shape
    idx = torch.as_tensor(np.asarray(layout.pad_index, np.int64).reshape(-1), device=v.device)
    src = keep_padded.reshape(-1, t) & (idx >= 0)[:, None]
    keep = torch.zeros((s, t), dtype=torch.int32, device=v.device)
    keep.index_add_(0, idx.clamp(0, s - 1), src.to(torch.int32))
    return torch.where(keep > 0, v, torch.nan)


def topk(values, layout: GroupLayout, k: int):
    return _take(values, layout, k, largest=True)


def bottomk(values, layout: GroupLayout, k: int):
    return _take(values, layout, k, largest=False)


def count_values(values, series: list[SeriesMeta], label: bytes):
    """count_values (count_values.go): per step, count series sharing each
    distinct value. On the host, as the reference does it: the output's
    cardinality depends on the data. Returns (f64 values[G, T] on the
    values' device, metas)."""
    t = torch.as_tensor(values)
    vals = t.cpu().numpy()
    uniq = np.unique(vals[~np.isnan(vals)])
    out = np.full((len(uniq), vals.shape[1]), np.nan)
    metas = []
    for i, u in enumerate(uniq):
        cnt = np.sum(vals == u, axis=0).astype(np.float64)
        out[i] = np.where(cnt > 0, cnt, np.nan)
        metas.append(SeriesMeta(tags=((label, repr(float(u)).encode()),)))
    return torch.from_numpy(out).to(t.device), metas
