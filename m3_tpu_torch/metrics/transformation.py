"""Transformation ops for rollup pipelines.

A copy of ``m3_tpu/metrics/transformation.py`` (host numpy over a
rollup's window sequence; no device work).

Reference: M3's src/metrics/transformation/{unary,binary}.go.
Vectorized over [T] window sequences: binary ops consume (prev, curr)
adjacent flushes; emptyDatapoint becomes NaN.
"""

from __future__ import annotations

import numpy as np

NANOS = 1_000_000_000


def absolute(times: np.ndarray, values: np.ndarray):
    return times, np.abs(values)


def add(times: np.ndarray, values: np.ndarray):
    """binary.go add: curr + prev (NaN prev treated as 0 reset... reference
    returns curr when prev is NaN via emptyDatapoint guard)."""
    prev = np.concatenate([[np.nan], values[:-1]])
    out = np.where(np.isnan(prev), values, values + prev)
    return times, out


def _binary_guard(times, values):
    prev_v = np.concatenate([[np.nan], values[:-1]])
    prev_t = np.concatenate([[np.iinfo(np.int64).max], times[:-1]])
    bad = (prev_t >= times) | np.isnan(prev_v) | np.isnan(values)
    return prev_v, prev_t, bad


def per_second(times: np.ndarray, values: np.ndarray):
    prev_v, prev_t, bad = _binary_guard(times, values)
    diff = values - prev_v
    bad |= diff < 0
    dt = (times - prev_t).astype(np.float64)
    out = np.where(bad, np.nan, diff * NANOS / np.where(dt == 0, 1, dt))
    return times, out


def increase(times: np.ndarray, values: np.ndarray):
    prev_v, prev_t, bad = _binary_guard(times, values)
    diff = values - prev_v
    bad |= diff < 0
    return times, np.where(bad, np.nan, diff)


def reset(times: np.ndarray, values: np.ndarray):
    """unary.go reset: emit 0 (used to mark counter resets downstream)."""
    return times, np.zeros_like(values)


APPLY = {
    1: absolute,  # TransformationType.ABSOLUTE
    2: per_second,
    3: increase,
    4: add,
    5: reset,
}


def apply_pipeline(pipeline, times: np.ndarray, values: np.ndarray):
    for op in pipeline:
        times, values = APPLY[int(op)](times, values)
    return times, values
