"""Temporal (windowed, per-series) functions in plain PyTorch: B2's twin.

Port of the 15 ``FUSABLE`` functions of ``m3_tpu/query/functions/
temporal.py`` and their helpers, with the same operation order as the jnp
code (the doubling trees of ``_win_reduce`` / ``_win_reduce_tuple``,
``_ffill``, ``_prev_valid`` and ``_pair_event_window_sum``), so on the CPU
the twin matches the jnp formulas to rounding. ``chip_smoke.py`` holds the
CUDA kernel (``temporal_fused.py``) against it on the card.

Conventions (as the reference's): ``values`` is float32 [S, T] on a
regular step grid, NaN = missing; ``window`` counts grid steps, inclusive
of both ends; output[t] covers input steps [t - window + 1, t], clipped at
the left edge. ``deriv``, ``predict_linear``, ``holt_winters`` and
``quantile_over_time`` are not fusable and are not ported yet.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _shift(a, j: int, fill):
    """a shifted right by j along time: out[:, t] = a[:, t - j], ``fill``
    on the left (jnp.pad + slice)."""
    s, t = a.shape
    pad = torch.full((s, min(j, t)), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[:, : max(t - j, 0)]], dim=1)


def _win_reduce(x, window: int, op, fill):
    # doubling tree: acc covers a suffix window of width w; op(earlier, later)
    acc = x
    w = 1
    while w * 2 <= window:
        acc = op(_shift(acc, w, fill), acc)
        w *= 2
    if w < window:
        rest = _win_reduce(x, window - w, op, fill)
        acc = op(_shift(rest, w, fill), acc)
    return acc


def _win_sum(x, window):
    return _win_reduce(x, window, torch.add, 0.0)


def _win_max(x, window):
    return _win_reduce(x, window, torch.maximum, -torch.inf)


def _win_min(x, window):
    return _win_reduce(x, window, torch.minimum, torch.inf)


def _valid(values):
    return ~torch.isnan(values)


def _masked(values, fill=0.0):
    return torch.where(_valid(values), values, fill)


# ---------------------------------------------------------------------------
# *_over_time aggregations
# ---------------------------------------------------------------------------


def _sum_count(values, window):
    s = _win_sum(_masked(values), window)
    c = _win_sum(_valid(values).to(values.dtype), window)
    return s, c


def sum_over_time(values, window):
    s, c = _sum_count(values, window)
    return torch.where(c > 0, s, torch.nan)


def count_over_time(values, window):
    _, c = _sum_count(values, window)
    return torch.where(c > 0, c, torch.nan)


def avg_over_time(values, window):
    s, c = _sum_count(values, window)
    return torch.where(c > 0, s / c, torch.nan)


def min_over_time(values, window):
    c = _win_sum(_valid(values).to(values.dtype), window)
    m = _win_min(_masked(values, torch.inf), window)
    return torch.where(c > 0, m, torch.nan)


def max_over_time(values, window):
    c = _win_sum(_valid(values).to(values.dtype), window)
    m = _win_max(_masked(values, -torch.inf), window)
    return torch.where(c > 0, m, torch.nan)


def last_over_time(values, window):
    last_idx, last_val = _win_last_valid(values, window)
    return torch.where(last_idx >= 0, last_val, torch.nan)


def stdvar_over_time(values, window):
    # population variance over the window, NaN unless >= 2 points; a
    # per-series baseline (the row's nanmean) is subtracted first so the
    # f32 E[x^2] - mean^2 sums do not cancel for large-mean series
    valid = _valid(values)
    baseline = torch.nanmean(torch.where(valid, values, torch.nan), dim=1, keepdim=True)
    baseline = torch.where(torch.isnan(baseline), 0.0, baseline)
    x = torch.where(valid, values - baseline, 0.0)
    s = _win_sum(x, window)
    ss = _win_sum(x * x, window)
    c = _win_sum(valid.to(values.dtype), window)
    mean = s / torch.clamp(c, min=1)
    var = ss / torch.clamp(c, min=1) - mean * mean
    return torch.where(c >= 2, torch.clamp(var, min=0), torch.nan)


def stddev_over_time(values, window):
    return torch.sqrt(stdvar_over_time(values, window))


# ---------------------------------------------------------------------------
# window index machinery
# ---------------------------------------------------------------------------


def _win_reduce_tuple(arrs, fills, window: int, op):
    def shift(t_arrs, j):
        return tuple(_shift(a, j, f) for a, f in zip(t_arrs, fills))

    # op(earlier_half, later_half): the shifted copy is the earlier half
    acc = tuple(arrs)
    w = 1
    while w * 2 <= window:
        acc = op(shift(acc, w), acc)
        w *= 2
    if w < window:
        rest = _win_reduce_tuple(arrs, fills, window - w, op)
        acc = op(shift(rest, w), acc)
    return acc


def _comb_later(a, b):
    """b covers the later half: take b's entry when it saw a valid sample
    (component 0 is the valid-sample index, -1 = none)."""
    sel = b[0] >= 0
    return tuple(torch.where(sel, bb, aa) for aa, bb in zip(a, b))


def _comb_earlier(a, b):
    sel = a[0] >= 0
    return tuple(torch.where(sel, aa, bb) for aa, bb in zip(a, b))


def _iota_valid(values):
    s, t = values.shape
    idx = torch.arange(t, dtype=torch.int32, device=values.device).expand(s, t)
    return torch.where(_valid(values), idx, -1)


def _fill_of(a):
    return 0.0 if a.dtype.is_floating_point else -1


def _win_last_valid(values, window, extras=()):
    """(last_idx, last_val, *extras at the last valid sample) per window."""
    arrs = (_iota_valid(values), _masked(values)) + tuple(extras)
    return _win_reduce_tuple(arrs, tuple(_fill_of(a) for a in arrs), window, _comb_later)


def _win_first_valid(values, window, extras=()):
    """(first_idx, first_val, *extras at the first valid sample); idx -1
    when the window holds no valid sample."""
    arrs = (_iota_valid(values), _masked(values)) + tuple(extras)
    return _win_reduce_tuple(arrs, tuple(_fill_of(a) for a in arrs), window, _comb_earlier)


def _ffill(values):
    """Forward fill along time: out[t] = last valid value at index <= t
    (NaN before any valid sample), by log-depth doubling."""
    x = values
    t = x.shape[1]
    j = 1
    while j < t:
        x = torch.where(torch.isnan(x), _shift(x, j, torch.nan), x)
        j *= 2
    return x


def _prev_valid_val(values):
    """Per index t: value of the last valid sample at index < t (NaN none)."""
    return _shift(_ffill(values), 1, torch.nan)


def _prev_valid(values):
    """Per index t: (prev_idx, prev_val) of the last valid sample at index < t."""
    t = values.shape[1]
    iv = _iota_valid(values)
    vv = _masked(values)
    j = 1
    while j < t:
        hole = iv < 0
        iv, vv = (torch.where(hole, _shift(iv, j, -1), iv),
                  torch.where(hole, _shift(vv, j, 0.0), vv))
        j *= 2
    prev_idx = _shift(iv, 1, -1)
    prev_val = _shift(vv, 1, 0.0)
    return prev_idx, torch.where(prev_idx >= 0, prev_val, torch.nan)


def _pair_event_window_sum(values, event_amount, window):
    """Windowed sum of per-sample pair events, excluding the event attached
    to the window's FIRST valid sample (its pair partner lies before the
    window)."""
    wsum = _win_sum(event_amount, window)
    first_idx, _, first_event = _win_first_valid(values, window, extras=(event_amount,))
    (last_idx,) = _win_reduce_tuple((_iota_valid(values),), (-1,), window, _comb_later)
    first_event = torch.where(first_idx >= 0, first_event, 0.0)
    return wsum - first_event, last_idx, first_idx


# ---------------------------------------------------------------------------
# rate family
# ---------------------------------------------------------------------------


def _rate_impl(values, window, step_seconds, is_rate, is_counter):
    t = values.shape[1]
    duration = (window - 1) * step_seconds

    prev_val = _prev_valid_val(values)
    valid = _valid(values)
    reset = valid & ~torch.isnan(prev_val) & (values < prev_val)
    corr_amount = torch.where(reset & is_counter, _masked(prev_val), 0.0)
    corr, last_idx, first_idx = _pair_event_window_sum(values, corr_amount, window)
    _, last_val = _win_last_valid(values, window)
    _, first_val = _win_first_valid(values, window)

    has_two = (last_idx >= 0) & (first_idx >= 0) & (last_idx != first_idx)
    li = torch.clamp(last_idx, min=0)
    fi = torch.clamp(first_idx, min=0)

    # grid times relative to each output step's range end, in seconds
    out_idx = torch.arange(t, dtype=torch.int32, device=values.device).to(F32)[None, :]
    t_last = (li.to(F32) - out_idx) * step_seconds  # <= 0
    t_first = (fi.to(F32) - out_idx) * step_seconds
    range_start = -duration

    duration_to_start = t_first - range_start
    duration_to_end = -t_last
    sampled_interval = t_last - t_first
    avg_between = sampled_interval / torch.clamp((li - fi).to(F32), min=1)

    result = last_val - first_val + corr
    if is_counter:
        # zero-point extrapolation clamp
        dur_to_zero = sampled_interval * (first_val / torch.where(result > 0, result, 1.0))
        clamp = (result > 0) & (first_val >= 0)
        duration_to_start = torch.where(
            clamp & (dur_to_zero < duration_to_start), dur_to_zero, duration_to_start
        )

    threshold = avg_between * 1.1
    extrap = sampled_interval
    extrap = extrap + torch.where(duration_to_start < threshold, duration_to_start, avg_between / 2)
    extrap = extrap + torch.where(duration_to_end < threshold, duration_to_end, avg_between / 2)

    result = result * (extrap / torch.clamp(sampled_interval, min=1e-30))
    if is_rate:
        result = result / duration
    return torch.where(has_two, result, torch.nan)


def rate(values, window, step_seconds):
    return _rate_impl(values, window, step_seconds, is_rate=True, is_counter=True)


def increase(values, window, step_seconds):
    return _rate_impl(values, window, step_seconds, is_rate=False, is_counter=True)


def delta(values, window, step_seconds):
    return _rate_impl(values, window, step_seconds, is_rate=False, is_counter=False)


def _irate_impl(values, window, step_seconds, is_rate):
    """Last two valid samples in the window."""
    t = values.shape[1]
    prev_idx, prev_val = _prev_valid(values)
    # second-to-last valid = prev_valid AT the last valid sample
    last_idx, last_val, second_idx, second_val = _win_last_valid(
        values, window, extras=(prev_idx, _masked(prev_val))
    )
    li = torch.clamp(last_idx, min=0)
    window_start = torch.arange(t, dtype=torch.int32, device=values.device)[None, :] - (window - 1)
    ok = (last_idx >= 0) & (second_idx >= 0) & (second_idx >= window_start)
    res = last_val - second_val
    if is_rate:
        dt_s = (li - second_idx).to(values.dtype) * step_seconds
        res = res / torch.clamp(dt_s, min=1e-30)
    return torch.where(ok, res, torch.nan)


def irate(values, window, step_seconds):
    return _irate_impl(values, window, step_seconds, is_rate=True)


def idelta(values, window, step_seconds):
    return _irate_impl(values, window, step_seconds, is_rate=False)


# ---------------------------------------------------------------------------
# resets / changes
# ---------------------------------------------------------------------------


def _count_pairs(values, window, cmp):
    prev_val = _prev_valid_val(values)
    valid = _valid(values)
    event = valid & ~torch.isnan(prev_val) & cmp(values, prev_val)
    count, _, _ = _pair_event_window_sum(values, event.to(values.dtype), window)
    # NaN iff no valid sample after the window's first slot; validity at the
    # first slot is a static shift (left-edge windows clamp it to column 0)
    t = values.shape[1]
    w1 = window - 1
    dtv = valid.to(values.dtype)
    shifted = _shift(dtv, w1, 0.0)
    colmask = torch.arange(t, dtype=torch.int32, device=values.device)[None, :] < w1
    first_slot = torch.where(colmask, dtv[:, :1], shifted)
    valid_after_first = _win_sum(dtv, window) - first_slot
    return torch.where(valid_after_first > 0, count, torch.nan)


def resets(values, window):
    return _count_pairs(values, window, lambda c, p: c < p)


def changes(values, window):
    return _count_pairs(values, window, lambda c, p: c != p)
