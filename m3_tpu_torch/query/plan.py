"""Step-grid consolidation of decoded records, on the records' device.

Port of the consolidation stage of ``m3_tpu/query/plan.py`` (the fused
program's stage 5, ``plan.py:360-425``, and ``_finalize_grid``): the value
at grid step t is the last valid sample in (t - lookback, t], the rule of
``engine.consolidate_row``. Timestamps are native int64 here, not (hi, lo)
pairs; the result equals the host rule bit for bit in float64.
"""

from __future__ import annotations

import torch

from ..ops import decode as D


def consolidate_grid(res: D.DecodeResult, lo: int, hi: int, grid, lookback: int):
    """Records [S, P] (time-ordered over each row's valid records) → the
    step grid. Returns (values float64[S, T] with NaN where no sample is in
    the lookback window, the number of valid records in ``[lo, hi)``).

    ``grid`` is the int64 step timestamps; ``[lo, hi)`` the fetch window."""
    ts = res.ts
    dev = ts.device
    s, p = ts.shape
    g = torch.as_tensor(grid, dtype=torch.int64, device=dev)
    valid = res.valid & (ts >= lo) & (ts < hi)
    datapoints = int(valid.sum())
    if s == 0:
        return torch.empty((0, g.numel()), dtype=torch.float64, device=dev), datapoints
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
    return torch.where(ok, values, torch.nan), datapoints
