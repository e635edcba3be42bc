"""Batched aggregation kernels of the aggregator tier: kernels B-5a and B-5b.

Port of ``m3_tpu/aggregator/kernels.py``'s flush path. ``window_keys`` and
``pack_dense_groups`` are host numpy copies (the flush densifies a policy's
buffered datapoints into groups of one (metric, window) each, f32 [G, P]
with NaN padding). For CUDA tensors ``aggregate_dense`` launches kernel
B-5a and ``dense_quantiles`` kernel B-5b (``csrc/rollup.cu``); for CPU
tensors they run their plain PyTorch twins, which repeat the reference's
arithmetic on the CPU under XLA step for step, so the kernel, the twin and
the reference agree bit for bit:

- f32 subnormals flush to a zero of the same sign, operands and results;
- a row sum over P <= 32 slots adds in slot order from +0; over P > 32 it
  is XLA's tree: 32-slot windows (the row padded by floor(pad / 2) slots
  in front to a multiple of 32; the last window ends at the row's last
  slot, with no padding added behind it), each summed in slot order from
  +0, then the window sums the same way until at most 32 are left;
- XLA's CPU code fuses some multiply-adds: the plain row reduce of x * x
  (P <= 32) is acc = fma(x, x, acc) (the windowed one is not), the
  stdev's numerator is fma(c, sum_sq, -(sum * sum)) and the quantile's
  interpolation fma(vhi - vlo, frac, vlo); the twins compute an f32 fma
  exactly in f64 (round to odd);
- min and max order -0 below +0 and propagate NaN; ``last`` of -0 is +0;
- over P = 1 slot XLA drops the reduce: sum, min, max and last are the
  slot's value as it is (-0 and subnormals kept).

The reference is not one function on subnormal inputs to min and max: over
2-4 slots XLA's vectorized code returns some unflushed (the rows it
handles outside its vector loop). The port flushes them in every row, as
K3 does; the tests hold those to the reference's values flushed.

``aggregate_segments`` and ``segment_quantiles`` (the same over unsorted
keys) have no caller in the flush path and are not ported (ROADMAP §B,
B-5s).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import device_guard
from ..metrics.types import AggregationType
from ..ops._build import launch_error, load_library

F32 = torch.float32
FIELDS = ("sum", "count", "min", "max", "sum_sq", "mean", "stdev", "last")
MAX_QUANTILES = 32  # kMaxQuantiles of csrc/rollup.cu
_WINDOW = 32  # XLA's tree-reduction window
_FLT_MIN = float(np.finfo(np.float32).tiny)
_I32_MIN = int(np.iinfo(np.int32).min)

# Launches of each kernel, counted by its wrapper where it launches.
LAUNCHES = {"aggregate_dense": 0, "dense_quantiles": 0}


class WindowedAggregates(NamedTuple):
    """[G] tensors keyed by dense (metric, window) group id."""

    sum: torch.Tensor
    count: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    sum_sq: torch.Tensor
    mean: torch.Tensor
    stdev: torch.Tensor
    last: torch.Tensor


def window_keys(
    ids: np.ndarray, times_nanos: np.ndarray, window0_nanos: int, resolution_nanos: int, n_windows: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side exact i64 window bucketing → (keys, window_idx, time_order).

    keys = id * n_windows + window_idx (dense group key); time_order is an
    i32 within-window ordering value for `last` resolution (nanos offset
    clipped to i32 — windows are << 2s only for sub-second resolutions, where
    ns offsets still fit i32 after downshift)."""
    w = (times_nanos - window0_nanos) // resolution_nanos
    w = np.clip(w, 0, n_windows - 1)
    keys = ids.astype(np.int64) * n_windows + w
    # i32 keys only when they fit (grids past INT32_MAX groups keep i64 —
    # downstream pack_dense_groups indexes in i64 either way)
    if keys.size == 0 or int(keys.max()) <= np.iinfo(np.int32).max:
        keys = keys.astype(np.int32)
    off = times_nanos - (window0_nanos + w * resolution_nanos)
    # shift so the order value always fits i32 regardless of resolution
    shift = 0
    maxoff = int(off.max(initial=0))
    while maxoff >> shift > 0x3FFFFFFF:
        shift += 1
    return keys, w.astype(np.int32), (off >> shift).astype(np.int32)


def pack_dense_groups(keys, values, time_order, n_groups: int):
    """Host densification: (keys[n], values[n], time_order[n]) →
    (vals[G, P], torder[G, P], valid[G, P]) with NaN/0 padding. Arrival
    order within a group is preserved (stable sort) so `last` tie-breaking
    keeps first-arrival-wins semantics."""
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.float32)
    torder = np.asarray(time_order, np.int32)
    n = len(keys)
    counts = np.bincount(keys, minlength=n_groups)
    p = max(int(counts.max(initial=0)), 1)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos = np.arange(n, dtype=np.int64) - starts[ks]
    vals = np.full((n_groups, p), np.nan, np.float32)
    tor = np.zeros((n_groups, p), np.int32)
    vals[ks, pos] = values[order]
    tor[ks, pos] = torder[order]
    return vals, tor, ~np.isnan(vals)


def _values(vals):
    """vals as an f32 [G, P] tensor (on its own device)."""
    vals = torch.as_tensor(vals).to(F32)
    if vals.dim() != 2 or vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"want [G, P] values on the CPU or a card, got shape "
                         f"{tuple(vals.shape)} on {vals.device}")
    return vals


def _like(x, dtype, vals):
    """x as ``dtype`` on vals' device, of vals' shape."""
    x = torch.as_tensor(x, device=vals.device).to(dtype)
    if x.shape != vals.shape:
        raise ValueError(f"want [G, P] = {tuple(vals.shape)}, got {tuple(x.shape)}")
    return x


def _check_launch(vals, **others) -> None:
    """A launch's inputs: contiguous [G, P] tensors of their dtypes on one
    card (vals f32; torder i32, valid bool). The kernels read the aligned
    16-byte chunks that hold a tensor's first and last bytes whole (see
    csrc/rollup.cu): tensors from torch's allocator, or buffers padded to
    16 bytes, keep those reads inside an allocation."""
    dtypes = {"vals": F32, "torder": torch.int32, "valid": torch.bool}
    for name, t in {"vals": vals, **others}.items():
        if (t.dtype != dtypes[name] or not t.is_contiguous() or t.device != vals.device
                or t.device.type != "cuda" or t.dim() != 2 or t.shape != vals.shape):
            raise ValueError(f"want contiguous {dtypes[name]} [G, P] {name} on vals' card, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def aggregate_dense(vals, torder, valid) -> WindowedAggregates:
    """WindowedAggregates over dense [G, P] groups (counter/gauge Update
    semantics: last takes the greatest time order, the first slot on ties),
    each field f32 [G] on vals' device: kernel B-5a for a CUDA tensor (one
    launch; raises if the build or the launch fails), its twin for a CPU
    tensor."""
    return WindowedAggregates(*aggregate_dense_fields(vals, torder, valid))


def aggregate_dense_fields(vals, torder, valid) -> torch.Tensor:
    """The eight fields as one f32 [8, G] tensor, in ``FIELDS`` order."""
    vals = _values(vals)
    torder, valid = _like(torder, torch.int32, vals), _like(valid, torch.bool, vals)
    if vals.device.type == "cpu":
        return aggregate_dense_reference(vals, torder, valid)
    return launch_aggregate_dense(vals.contiguous(), torder.contiguous(), valid.contiguous())


def launch_aggregate_dense(vals, torder, valid) -> torch.Tensor:
    """B-5a on contiguous f32 vals, i32 torder and bool valid [G, P] on one
    card: f32 [8, G]."""
    _check_launch(vals, torder=torder, valid=valid)
    g, p = vals.shape
    out = torch.empty((len(FIELDS), g), dtype=F32, device=vals.device)
    if g == 0:
        return out
    lib = load_library("rollup")
    with device_guard(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.m3_aggregate_dense(vals.data_ptr(), torder.data_ptr(), valid.data_ptr(), g, p,
                                    out.data_ptr(), stream)
    if rc != 0:
        raise launch_error("aggregate_dense", rc, vals=vals, torder=torder, valid=valid, out=out)
    LAUNCHES["aggregate_dense"] += 1
    return out


def _check_quantiles(qs) -> tuple:
    qs = tuple(float(q) for q in qs)
    if not 1 <= len(qs) <= MAX_QUANTILES:
        raise ValueError(f"want 1 to {MAX_QUANTILES} quantiles, got {len(qs)}")
    if not all(0.0 <= q <= 1.0 for q in qs):
        raise ValueError(f"quantiles must lie in [0, 1], got {qs}")
    return qs


def dense_quantiles(vals, valid, qs: tuple) -> torch.Tensor:
    """Exact per-group quantiles over dense [G, P]: f32 [len(qs), G] on
    vals' device, with the CM stream's Quantile() interpolation (rank =
    q * (n - 1), linear between the floor and the next value), NaN for an
    empty group. Kernel B-5b for a CUDA tensor (one launch), its twin for
    a CPU tensor."""
    vals = _values(vals)
    valid = _like(valid, torch.bool, vals)
    qs = _check_quantiles(qs)
    if vals.device.type == "cpu":
        return dense_quantiles_reference(vals, valid, qs)
    return launch_dense_quantiles(vals.contiguous(), valid.contiguous(), qs)


def launch_dense_quantiles(vals, valid, qs: tuple) -> torch.Tensor:
    """B-5b on contiguous f32 vals and bool valid [G, P] on one card: f32
    [len(qs), G]. A row of P <= 8 slots, or of at most 8 valid slots,
    takes a thread; one of up to 32 valid slots a warp; a longer one a
    block in a second launch, through a work list in scratch allocated
    here."""
    qs = _check_quantiles(qs)
    _check_launch(vals, valid=valid)
    g, p = vals.shape
    out = torch.empty((len(qs), g), dtype=F32, device=vals.device)
    if g == 0:
        return out
    # the long rows' work list: a count, then up to g rows (read only where rows are that long)
    scratch = torch.empty(g + 1, dtype=torch.int64, device=vals.device)
    q = (ctypes.c_float * len(qs))(*qs)
    lib = load_library("rollup")
    with device_guard(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.m3_dense_quantiles(vals.data_ptr(), valid.data_ptr(), g, p, q, len(qs),
                                    scratch.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise launch_error("dense_quantiles", rc, vals=vals, valid=valid, scratch=scratch,
                           out=out)
    LAUNCHES["dense_quantiles"] += 1
    return out


# --- the twins (plain PyTorch, on the CPU and on the card alike) ---


def _ftz(x):
    """Flush f32 subnormals to a zero of the same sign."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def _add(a, b):
    return _ftz(_ftz(a) + _ftz(b))


def _mul(a, b):
    return _ftz(_ftz(a) * _ftz(b))


def _div(a, b):
    """IEEE f32 division (rounded once: the f64 quotient of two f32 values
    rounds to the same f32)."""
    return _ftz((_ftz(a).double() / _ftz(b).double()).to(F32))


def _sqrt(x):
    """IEEE f32 square root, as ``_div`` (torch's f32 sqrt on the CPU is
    not always correctly rounded)."""
    return _ftz(torch.sqrt(_ftz(x).double()).to(F32))


def _fma(a, b, c):
    """f32 fma(a, b, c) with flushed operands and result, exact: the
    product is exact in f64 and the f64 sum is rounded to odd (TwoSum's
    error), so its rounding to f32 is the fused one."""
    a, b, c = _ftz(a).double(), _ftz(b).double(), _ftz(c).double()
    prod = a * b
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    inexact = torch.isfinite(s) & (err != 0)
    bits = s.view(torch.int64)
    bits = torch.where(inexact & ((err > 0) != (s > 0)), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return _ftz(bits.view(torch.float64).to(F32))


def _picked(x):
    """A value summed from +0 with zeros beside it: flushed, -0 to +0."""
    y = _ftz(x)
    return torch.where(y == 0, torch.zeros_like(y), y)


def _row_sum(x):
    """XLA's row sum of flushed f32 [G, P] (see the module's note)."""
    g, n = x.shape
    while n > _WINDOW:
        m = -(-n // _WINDOW)
        lo = (m * _WINDOW - n) // 2
        padded = torch.zeros((g, m * _WINDOW), dtype=F32, device=x.device)
        padded[:, lo:lo + n] = x  # +0 slots: a window sum from +0 is never -0
        w = padded.view(g, m, _WINDOW)
        acc = torch.zeros((g, m), dtype=F32, device=x.device)
        end = lo + n - (m - 1) * _WINDOW  # the last window ends at its last item
        for k in range(_WINDOW):
            j = m if k < end else m - 1  # no back padding: it would turn a -0 sum to +0
            acc[:, :j] = _add(acc[:, :j], w[:, :j, k])
        x, n = acc, m
    acc = torch.zeros(g, dtype=F32, device=x.device)
    for k in range(n):
        acc = _add(acc, x[:, k])
    return acc


def _order_key(x):
    """int32 keys in IEEE order of f32 x (-0 below +0; NaN not ordered)."""
    bits = x.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _extreme(x, valid, fill: float, largest: bool):
    """IEEE minimum (maximum) of each row's flushed valid values: NaN if
    one is NaN, -0 below +0."""
    x = _ftz(torch.where(valid, x, torch.full_like(x, fill)))
    key = _order_key(x)
    key = key.amax(1) if largest else key.amin(1)
    out = torch.where(key < 0, key ^ 0x7FFFFFFF, key).view(F32)
    return torch.where(x.isnan().any(1), torch.full_like(out, float("nan")), out)


def aggregate_dense_reference(vals, torder, valid) -> torch.Tensor:
    """B-5a's twin: f32 [8, G] on vals' device (see the module's note)."""
    g, p = vals.shape
    zero = torch.zeros(g, dtype=F32, device=vals.device)
    nan = torch.full((g,), float("nan"), dtype=F32, device=vals.device)
    if p == 0:
        return torch.stack([zero, zero, nan, nan, zero, zero, zero, nan])
    c = valid.sum(1).to(F32)
    if p == 1:
        # XLA drops a reduce over one slot: the slot's value as it is
        v0 = torch.where(valid, vals, torch.zeros_like(vals))[:, 0]
        s, ss, last = v0, _mul(v0, v0), v0
        mn = torch.where(valid, vals, torch.full_like(vals, float("inf")))[:, 0]
        mx = torch.where(valid, vals, torch.full_like(vals, float("-inf")))[:, 0]
    else:
        v0 = _ftz(torch.where(valid, vals, torch.zeros_like(vals)))
        s = _row_sum(v0)
        if p <= _WINDOW:
            ss = zero
            for k in range(p):
                ss = _fma(v0[:, k], v0[:, k], ss)
        else:
            ss = _row_sum(_mul(v0, v0))
        mn = _extreme(vals, valid, float("inf"), largest=False)
        mx = _extreme(vals, valid, float("-inf"), largest=True)
        t_eff = torch.where(valid, torder, torch.full_like(torder, _I32_MIN))
        is_best = t_eff == t_eff.amax(1, keepdim=True)
        pos = torch.arange(p, device=vals.device).expand(g, p)
        first = torch.where(is_best, pos, torch.full_like(pos, p)).amin(1, keepdim=True)
        last = _picked(v0.gather(1, first)[:, 0])
    one = torch.ones_like(c)
    mean = torch.where(c > 0, _div(s, torch.where(c > 1, c, one)), zero)
    div = _mul(c, _add(c, -one))
    var = _div(_fma(c, ss, -_mul(s, s)), torch.where(div == 0, one, div))
    sd = _sqrt(torch.where((var > 0) | var.isnan(), var, zero))
    sd = torch.where(div == 0, zero, sd)
    empty = c == 0
    return torch.stack([
        torch.where(empty, zero, s), c, torch.where(empty, nan, mn),
        torch.where(empty, nan, mx), torch.where(empty, zero, ss), mean, sd,
        torch.where(empty, nan, last),
    ])


def dense_quantiles_reference(vals, valid, qs: tuple) -> torch.Tensor:
    """B-5b's twin: f32 [len(qs), G] on vals' device (see the module's
    note): a sort along P, the rank picks and the fused interpolation."""
    g, p = vals.shape
    nan = torch.full((g,), float("nan"), dtype=F32, device=vals.device)
    if p == 0:
        return torch.stack([nan] * len(qs))
    sv = torch.sort(torch.where(valid, vals, torch.full_like(vals, float("inf"))), dim=1).values
    n = valid.sum(1).to(F32)
    zero = torch.zeros_like(n)
    cm = torch.where(n > 1, _add(n, -torch.ones_like(n)), zero)
    outs = []
    for q in qs:
        rank = _mul(torch.full_like(n, q), cm)
        lo = torch.floor(rank)
        hi = torch.minimum(lo + 1, cm)
        frac = _add(rank, -lo)
        vlo = _picked(sv.gather(1, lo.long()[:, None])[:, 0])
        vhi = _picked(sv.gather(1, hi.long()[:, None])[:, 0])
        outs.append(torch.where(n > 0, _fma(_add(vhi, -vlo), frac, vlo), nan))
    return torch.stack(outs)


def value_of(agg: WindowedAggregates, quantiles: dict, atype: AggregationType, g):
    """counter/timer/gauge ValueOf dispatch (counter.go:96-120 etc)."""
    q = atype.quantile()
    if q is not None:
        return quantiles[q][g]
    return {
        AggregationType.LAST: agg.last,
        AggregationType.MIN: agg.min,
        AggregationType.MAX: agg.max,
        AggregationType.MEAN: agg.mean,
        AggregationType.COUNT: agg.count,
        AggregationType.SUM: agg.sum,
        AggregationType.SUMSQ: agg.sum_sq,
        AggregationType.STDEV: agg.stdev,
    }[atype][g]
