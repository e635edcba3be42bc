"""Temporal (windowed, per-series) functions in plain PyTorch: the twins
of kernels B2 and B-7.

Port of ``m3_tpu/query/functions/temporal.py``. The 15 ``FUSABLE``
functions (B2's twin) keep the jnp code's operation order (the doubling
trees of ``_win_reduce`` / ``_win_reduce_tuple``, ``_ffill``,
``_prev_valid`` and ``_pair_event_window_sum``), so on the CPU they match
the jnp formulas to rounding. ``deriv``, ``predict_linear``,
``holt_winters`` and ``quantile_over_time`` (B-7's twin,
``temporal_window.py``) work on chunks of ``chunk`` output steps, as the
reference's do, and fold each window's slots one at a time in slot order:
that order is B-7's, which the card holds to these functions bit for bit;
no output depends on ``chunk``. ``chip_smoke.py`` holds both kernels
against their twins on the card.

Conventions (as the reference's): ``values`` is float32 [S, T] on a
regular step grid, NaN = missing; ``window`` counts grid steps, inclusive
of both ends; output[t] covers input steps [t - window + 1, t], clipped at
the left edge.
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


# ---------------------------------------------------------------------------
# B-7's twin: linear regression (temporal/linear_regression.go:145-190),
# holt_winters (temporal/holt_winters.go:77-141) and quantile_over_time
# ---------------------------------------------------------------------------


def _const(x: float, like):
    """``x`` rounded to float32, a 0-dim tensor on ``like``'s device (an
    operand of tensor ops, so no op divides by a host scalar)."""
    return torch.tensor(x, dtype=F32, device=like.device)


def _chunks(values, window: int, chunk: int):
    """(t0, slot) per chunk of output steps [t0, t0 + chunk): slot(j) is
    the [S, chunk] matrix of the windows' slot j (input step t - window + 1
    + j for output step t; NaN before step 0 and past the last)."""
    s, t = values.shape
    nchunks = -(-t // chunk)
    pad_l = torch.full((s, window - 1), torch.nan, dtype=F32, device=values.device)
    pad_r = torch.full((s, nchunks * chunk - t), torch.nan, dtype=F32, device=values.device)
    vp = torch.cat([pad_l, values.to(F32), pad_r], dim=1)
    for c in range(nchunks):
        t0 = c * chunk
        yield t0, lambda j, t0=t0: vp[:, t0 + j: t0 + j + chunk]


def _gather_windows(values, window, t0, chunk):
    """[S, chunk, W] windows ending at steps t0..t0+chunk-1 (NaN left-pad)."""
    values = torch.as_tensor(values)
    s, t = values.shape
    ends = t0 + torch.arange(chunk, device=values.device)
    offs = torch.arange(window, device=values.device) - (window - 1)
    idx = ends[:, None] + offs[None, :]  # [chunk, W]
    g = values[:, idx.clamp(0, t - 1)]  # [S, chunk, W]
    return torch.where((idx < 0)[None, :, :], torch.nan, g)


def _linreg_sums(values, window, step_seconds, chunk: int = 128):
    """Windowed least squares with timeDiff relative to the window end — the
    reference's interceptTime == evaluationTime (linear_regression.go:136),
    exact per-window recentering: the sums n, sum v, sum d, sum d^2 and
    sum d*v over the window's slots, folded in slot order (B-7's order)."""
    v = torch.as_tensor(values).to(F32)
    s, t = v.shape
    # time diff of window slot j (0..W-1) from the window end, in seconds
    d = (torch.arange(window, dtype=F32, device=v.device) - (window - 1)) * _const(step_seconds, v)
    dd = d * d
    slopes, intercepts = [], []
    for _, slot in _chunks(v, window, chunk):
        z = torch.zeros((s, chunk), dtype=F32, device=v.device)
        n, sv, sd, sdd, sdv = z, z, z, z, z
        for j in range(window):
            w = slot(j)
            ok = ~torch.isnan(w)
            x = torch.where(ok, w, 0.0)
            vi = ok.to(F32)
            n = n + vi
            sv = sv + x
            sd = sd + d[j] * vi
            sdd = sdd + dd[j] * vi
            sdv = sdv + d[j] * x
        nn = torch.clamp(n, min=1)
        cov = sdv - sd * sv / nn
        var = sdd - sd * sd / nn
        slope = cov / torch.where(var == 0, 1.0, var)
        intercept = sv / nn - slope * sd / nn
        good = n >= 2
        slopes.append(torch.where(good, slope, torch.nan))
        intercepts.append(torch.where(good, intercept, torch.nan))
    return torch.cat(slopes, dim=1)[:, :t], torch.cat(intercepts, dim=1)[:, :t]


def deriv(values, window, step_seconds, chunk: int = 128):
    slope, _ = _linreg_sums(values, window, step_seconds, chunk)
    return slope


def predict_linear(values, window, step_seconds, predict_seconds, chunk: int = 128):
    slope, intercept = _linreg_sums(values, window, step_seconds, chunk)
    return slope * _const(predict_seconds, slope) + intercept


def holt_winters(values, window, sf: float, tf: float, chunk: int = 128):
    """Double exponential smoothing over each window's valid samples in
    slot order (holt_winters.go:77-141): the trend is set on the second
    valid sample; NaN below two."""
    v = torch.as_tensor(values).to(F32)
    s, t = v.shape
    sf32, omsf, tf32, omtf = (_const(x, v) for x in (sf, 1 - sf, tf, 1 - tf))
    outs = []
    for _, slot in _chunks(v, window, chunk):
        z = torch.zeros((s, chunk), dtype=F32, device=v.device)
        no = torch.zeros((s, chunk), dtype=torch.bool, device=v.device)
        found1, found2, prev, curr, trend = no, no, z, z, z
        idx = torch.zeros((s, chunk), dtype=torch.int32, device=v.device)
        for j in range(window):
            x = slot(j)
            nan = torch.isnan(x)
            take1 = ~nan & ~found1
            take2 = ~nan & found1 & ~found2
            trend0 = torch.where(take2, x - curr, trend)
            upd = ~nan & found1
            trend_new = torch.where(idx - 1 == 0, trend0, tf32 * (curr - prev) + omtf * trend0)
            new_curr = sf32 * x + omsf * (curr + trend_new)
            curr, prev = torch.where(take1, x, torch.where(upd, new_curr, curr)), torch.where(upd, curr, prev)
            trend = torch.where(upd, trend_new, trend0)
            idx = torch.where(~nan, idx + 1, idx)
            found1 = found1 | ~nan
            found2 = found2 | take2
        outs.append(torch.where(found2, curr, torch.nan))
    return torch.cat(outs, dim=1)[:, :t]


def quantile_over_time(values, window, q: float, chunk: int = 128):
    """quantile over valid samples in window (aggregation.go:239-280): sort
    the gathered window (NaNs sort to the end), linear interpolate."""
    v = torch.as_tensor(values).to(F32)
    s, t = v.shape
    if q < 0 or q > 1:
        c = _win_sum(_valid(v).to(F32), window)
        return torch.where(c > 0, -torch.inf if q < 0 else torch.inf, torch.nan).to(F32)
    qf = _const(q, v)
    outs = []
    for t0 in range(0, t, chunk):
        w = _gather_windows(v, window, t0, chunk)  # [S, chunk, W]
        sw = torch.sort(w, dim=-1).values  # NaNs to the end
        n = (~torch.isnan(w)).sum(dim=-1)  # [S, chunk]
        rank = qf * (n - 1).to(F32)
        lo = torch.floor(rank).to(torch.int64).clamp(0, window - 1)
        hi = torch.minimum((lo + 1).clamp(0, window - 1), (n - 1).clamp(min=0))
        frac = rank - lo.to(F32)
        vlo = torch.gather(sw, -1, lo[..., None])[..., 0]
        vhi = torch.gather(sw, -1, hi[..., None])[..., 0]
        out = vlo + (vhi - vlo) * frac
        outs.append(torch.where(n > 0, out, torch.nan))
    return torch.cat(outs, dim=1)[:, :t]
