"""Synthetic M3TSZ series for benches and tests.

Port of ``m3_tpu/utils/synthetic.py``: the same numpy-seeded generators, so
a seed gives byte-identical streams in both packages. ``synthetic_streams``
encodes through the host codec library (``native.encode_batch``), as the
reference does; the mixed generator's per-series classes run the Python
encoder, as there.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..codec.m3tsz import Encoder, encode_series
from ..segment.batched import BatchedSegments
from .xtime import Unit

NANOS = 1_000_000_000


def _timestamps(rng, n_unique, n_points, start_nanos, step_nanos):
    ts = start_nanos + step_nanos * np.arange(n_points, dtype=np.int64)
    unit = Unit.SECOND if step_nanos % NANOS == 0 else Unit.MILLISECOND
    # jitter in whole units of the encode unit (sub-unit deltas would be
    # truncated by timestamp normalization) so non-zero dod buckets are
    # actually exercised
    jitter = rng.integers(-2, 3, size=(n_unique, n_points)) * unit.nanos()
    jitter[:, 0] = 0
    return ts[None, :] + jitter, unit


def synthetic_streams(
    n_unique: int,
    n_points: int,
    start_nanos: int = 1_600_000_000 * NANOS,
    step_nanos: int = 10 * NANOS,
    seed: int = 0,
    kind: str = "gauge",
) -> list[bytes]:
    """Encode ``n_unique`` synthetic series of ``n_points`` datapoints each.

    kind:
      gauge  — random-walk floats with ~2 decimal places (int-optimizable)
      counter— monotonically increasing integer-ish values
      float  — full-precision floats (exercise the XOR path)
    """
    rng = np.random.default_rng(seed)
    all_t, unit = _timestamps(rng, n_unique, n_points, start_nanos, step_nanos)
    if kind == "gauge":
        all_v = np.round(50 + np.cumsum(rng.normal(0, 1, (n_unique, n_points)), axis=1), 2)
    elif kind == "counter":
        all_v = np.cumsum(rng.integers(0, 100, (n_unique, n_points)), axis=1).astype(np.float64)
    else:
        all_v = rng.normal(0, 1, (n_unique, n_points))
    return native.encode_batch(
        all_t.ravel(), all_v.ravel(), np.full(n_unique, n_points, np.int32),
        default_unit=int(unit),
    )


def tiled_batch(
    n_series: int,
    n_points: int,
    n_unique: int = 64,
    seed: int = 0,
    kind: str = "gauge",
) -> BatchedSegments:
    """A BatchedSegments of ``n_series`` rows tiling ``n_unique`` encoded
    streams (row i is unique stream i % n_unique): million-series batches
    for the whole-stream decode without encoding every series."""
    streams = synthetic_streams(n_unique, n_points, seed=seed, kind=kind)
    base = BatchedSegments.from_streams(streams)
    reps = (n_series + n_unique - 1) // n_unique
    words = np.tile(base.words, (reps, 1))[:n_series]
    num_bits = np.tile(base.num_bits, reps)[:n_series]
    return BatchedSegments(words=words, num_bits=num_bits)


def synthetic_mixed_streams(
    n_unique: int,
    n_points: int,
    start_nanos: int = 1_600_000_000 * NANOS,
    step_nanos: int = 10 * NANOS,
    seed: int = 0,
    frac_float: float = 0.30,
    frac_counter: float = 0.08,
    frac_tu_change: float = 0.05,
    frac_annotation: float = 0.02,
) -> list[bytes]:
    """A mixed workload: by default 30% float-mode series (Gorilla XOR
    values), 8% counters, 5% streams with a mid-stream time-unit change, 2%
    with annotations, the rest int-optimizable gauges with 0-3 decimal
    places over 4 orders of magnitude. The class sequence is shuffled from
    the seed so tiling interleaves classes as a real shard does."""
    rng = np.random.default_rng(seed)
    all_t, unit = _timestamps(rng, n_unique, n_points, start_nanos, step_nanos)

    n_float = int(n_unique * frac_float)
    n_counter = int(n_unique * frac_counter)
    n_tu = int(n_unique * frac_tu_change)
    n_ann = int(n_unique * frac_annotation)
    n_gauge = n_unique - n_float - n_counter - n_tu - n_ann
    kinds = (
        ["gauge"] * n_gauge + ["float"] * n_float + ["counter"] * n_counter
        + ["tu"] * n_tu + ["ann"] * n_ann
    )
    rng.shuffle(kinds)

    out: list[bytes] = []
    for i, kind in enumerate(kinds):
        t_row = all_t[i]
        if kind == "gauge":
            decimals = int(rng.integers(0, 4))
            scale = 10.0 ** rng.integers(0, 5)
            vals = np.round(
                scale * (1 + 0.02 * np.cumsum(rng.normal(0, 1, n_points))),
                decimals,
            )
        elif kind == "counter":
            vals = np.cumsum(rng.integers(0, 1000, n_points)).astype(np.float64)
        else:  # float / tu / ann: full-precision values (XOR path)
            vals = rng.lognormal(0, 2, n_points)
        if kind == "tu":
            # switch s -> ms halfway (time-unit-change marker + 64-bit dod)
            enc = Encoder(int(t_row[0]))
            half = n_points // 2
            for j in range(n_points):
                u = unit if j < half else Unit.MILLISECOND
                enc.encode(int(t_row[j]), float(vals[j]), unit=u)
            out.append(enc.stream())
        elif kind == "ann":
            enc = Encoder(int(t_row[0]))
            ann_at = set(rng.integers(0, n_points, 3).tolist())
            for j in range(n_points):
                enc.encode(
                    int(t_row[j]), float(vals[j]), unit=unit,
                    annotation=b"deploy" if j in ann_at else None,
                )
            out.append(enc.stream())
        else:
            out.append(encode_series(t_row.tolist(), vals.tolist(), unit=unit))
    return out
