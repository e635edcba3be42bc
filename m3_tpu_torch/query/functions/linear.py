"""Linear (per-sample) functions, histogram_quantile and sort.

Port of ``m3_tpu/query/functions/linear.py`` (clamp.go, math.go, round.go,
sort.go, datetime.go, histogram_quantile.go in M3). The elementwise
functions run as torch on the values' device in float32, as the
reference's jnp code computes them; ``sort_series``, ``datetime_fn`` and
``histogram_buckets`` run on the host, as there. ``histogram_quantile``
groups series by tags-minus-le on the host and interpolates the buckets on
the device.
"""

from __future__ import annotations

import calendar
import math
import time as _time

import numpy as np
import torch

from ...block.core import SeriesMeta

__all__ = [
    "MATH_FNS",
    "clamp_min",
    "clamp_max",
    "round_to",
    "sort_series",
    "datetime_fn",
    "histogram_buckets",
    "histogram_quantile",
]

F32 = torch.float32


def _f32(values):
    return torch.as_tensor(values).to(F32)


def _const(x: float, like):
    """``x`` as a 0-dim tensor of ``like``'s dtype on its device (an
    operand of a tensor op, not a host scalar)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


MATH_FNS = {
    "abs": lambda v: torch.abs(_f32(v)),
    "ceil": lambda v: torch.ceil(_f32(v)),
    "floor": lambda v: torch.floor(_f32(v)),
    "exp": lambda v: torch.exp(_f32(v)),
    "sqrt": lambda v: torch.sqrt(_f32(v)),
    "ln": lambda v: torch.log(_f32(v)),
    "log2": lambda v: torch.log2(_f32(v)),
    "log10": lambda v: torch.log10(_f32(v)),
}


def clamp_min(values, scalar: float):
    v = _f32(values)
    return torch.maximum(v, _const(scalar, v))


def clamp_max(values, scalar: float):
    v = _f32(values)
    return torch.minimum(v, _const(scalar, v))


def round_to(values, to_nearest: float = 1.0):
    # round.go: floor(v/to + 0.5) * to. The quotient and the half are taken
    # in the values' dtype, the floor and the product in float32 (the
    # reference's numpy arithmetic, then jnp.floor).
    v = torch.as_tensor(values)
    x = (v / _const(to_nearest, v) + _const(0.5, v)).to(F32)
    return torch.floor(x) * _const(to_nearest, x)


def sort_series(values, descending: bool = False):
    """sort.go: order series by their last-step value (instant queries)."""
    vals = torch.as_tensor(values).cpu().numpy()
    key = vals[:, -1]
    # NaN series sort last in either direction
    key = np.where(np.isnan(key), np.inf if not descending else -np.inf, key)
    return np.argsort(-key if descending else key, kind="stable")


_DATETIME_FNS = {
    "day_of_month": lambda tm: tm.tm_mday,
    "day_of_week": lambda tm: (tm.tm_wday + 1) % 7,  # Go: Sunday = 0
    "days_in_month": None,  # special-cased below
    "hour": lambda tm: tm.tm_hour,
    "minute": lambda tm: tm.tm_min,
    "month": lambda tm: tm.tm_mon,
    "year": lambda tm: tm.tm_year,
}


def datetime_fn(name: str, values):
    """datetime.go: interpret values as unix seconds (UTC). On the host;
    float64 on the values' device."""
    t = torch.as_tensor(values)
    vals = t.cpu().numpy().astype(np.float64)
    out = np.full_like(vals, np.nan)
    it = np.nditer(vals, flags=["multi_index"])
    for v in it:
        fv = float(v)
        if math.isnan(fv):
            continue
        tm = _time.gmtime(fv)
        if name == "days_in_month":
            out[it.multi_index] = calendar.monthrange(tm.tm_year, tm.tm_mon)[1]
        else:
            out[it.multi_index] = _DATETIME_FNS[name](tm)
    return torch.from_numpy(out).to(t.device)


# ---------------------------------------------------------------------------
# histogram_quantile (histogram_quantile.go:153-384)
# ---------------------------------------------------------------------------

LE_TAG = b"le"


def histogram_buckets(series: list[SeriesMeta]):
    """Group series into histograms by tags-minus-le; sort buckets by le.

    Returns (index[G, B] int32 with -1 pad, bounds[G, B] f32 (+inf pad),
    metas[G]) — groups whose max bound isn't +Inf or with <2 buckets are
    dropped (sanitizeBuckets, :196-214)."""
    groups: dict = {}
    for i, sm in enumerate(series):
        le = None
        rest = []
        for k, v in sm.tags:
            if k == LE_TAG:
                le = v
            else:
                rest.append((k, v))
        if le is None:
            continue
        try:
            bound = float(le.decode())
        except ValueError:
            continue
        groups.setdefault(tuple(rest), []).append((bound, i))
    idxs, bounds, metas = [], [], []
    for key, buckets in groups.items():
        buckets.sort()
        bs = [b for b, _ in buckets]
        if len(buckets) < 2 or not math.isinf(bs[-1]) or bs[-1] < 0:
            continue
        idxs.append([i for _, i in buckets])
        bounds.append(bs)
        metas.append(SeriesMeta(tags=key))
    if not idxs:
        return np.zeros((0, 1), np.int32), np.zeros((0, 1), np.float32), []
    b = max(len(x) for x in idxs)
    index = np.full((len(idxs), b), -1, np.int32)
    bnd = np.full((len(idxs), b), np.inf, np.float32)
    for g, (ix, bo) in enumerate(zip(idxs, bounds)):
        index[g, : len(ix)] = ix
        bnd[g, : len(bo)] = bo
    return index, bnd, metas


def _pick(a, idx):
    """a[g, idx[g, t], t] for a [G, B, T] and idx [G, T]."""
    return torch.gather(a, 1, idx[:, None, :])[:, 0]


def histogram_quantile(q: float, values, index, bounds):
    """Vectorized bucketQuantile (:216-256) with ensureMonotonic (:321-331).

    values: [S, T]; index: [G, B] series row per bucket (-1 pad);
    bounds: [G, B] le upper bounds. Returns f32 [G, T]."""
    values = _f32(values)
    dev = values.device
    s, t = values.shape
    index = torch.as_tensor(np.asarray(index, np.int64), device=dev)
    bounds = torch.as_tensor(np.asarray(bounds, np.float32), device=dev)
    g, b = index.shape
    if g == 0:
        return torch.zeros((0, t), dtype=F32, device=dev)

    v = values[index.clamp(0, s - 1)]  # [G, B, T]
    valid = (index >= 0)[:, :, None] & ~torch.isnan(v)
    if q < 0 or q > 1:
        has = valid.any(dim=1)
        return torch.where(has, -torch.inf if q < 0 else torch.inf, torch.nan)

    # ensureMonotonic over valid buckets
    vm = torch.where(valid, v, -torch.inf)
    vm = torch.cummax(vm, dim=1).values
    v = torch.where(valid, torch.maximum(v, vm), v)

    le = bounds[:, :, None].expand(g, b, t)
    # last valid bucket must be the +Inf one
    bidx = torch.arange(b, device=dev)[None, :, None].expand(g, b, t)
    last_idx = torch.where(valid, bidx, -1).amax(dim=1)  # [G, T]
    n_valid = valid.sum(dim=1)
    top_le = _pick(le, last_idx.clamp(min=0))
    top_val = _pick(v, last_idx.clamp(min=0))
    ok = (n_valid >= 2) & torch.isinf(top_le) & (last_idx >= 0)

    rank = q * top_val  # [G, T]

    # first valid bucket (other than the last) with value >= rank
    cand = valid & (v >= rank[:, None, :]) & (bidx < last_idx[:, None, :])
    any_cand = cand.any(dim=1)
    first_cand = cand.to(torch.int32).argmax(dim=1)  # [G, T]

    # previous valid bucket before each bucket (for start bound / count)
    prev_idx = torch.cat(
        [torch.full((g, 1, t), -1, dtype=torch.int64, device=dev),
         torch.cummax(torch.where(valid, bidx, -1), dim=1).values[:, :-1]],
        dim=1,
    )  # [G, B, T] index of last valid bucket strictly before b

    cur_le = _pick(le, first_cand)
    cur_val = _pick(v, first_cand)
    p_idx = _pick(prev_idx, first_cand)  # [G, T]
    has_prev = p_idx >= 0
    p_sel = p_idx.clamp(min=0)
    prev_le = _pick(le, p_sel)
    prev_val = _pick(v, p_sel)

    bucket_start = torch.where(has_prev, prev_le, 0.0)
    count = cur_val - torch.where(has_prev, prev_val, 0.0)
    rank_adj = rank - torch.where(has_prev, prev_val, 0.0)
    interp = bucket_start + (cur_le - bucket_start) * rank_adj / torch.where(
        count == 0, 1.0, count
    )

    # edge cases
    first_valid = valid.to(torch.int32).argmax(dim=1)  # [G, T]
    fv_le = _pick(le, first_valid)
    is_first = (first_cand == first_valid) & (fv_le <= 0)
    result = torch.where(is_first, fv_le, interp)

    # no candidate below top: return second-last valid bucket's bound
    second_last = _pick(prev_idx, last_idx.clamp(min=0))
    sl_le = _pick(le, second_last.clamp(min=0))
    result = torch.where(any_cand, result, sl_le)

    return torch.where(ok, result, torch.nan)
