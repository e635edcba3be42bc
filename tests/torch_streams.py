"""Streams shared by the port's kernel tests: the host-build tests on the
CPU (tests/test_torch_records.py, tests/test_torch_fields.py) and the card
tests (tests/test_torch_cuda.py) decode the same warp mixes. Imports numpy
and the port only, so the card tests run without JAX."""

import numpy as np

from m3_tpu_torch.codec.m3tsz import encode_series
from m3_tpu_torch.utils.synthetic import synthetic_mixed_streams

T0 = 1_600_000_000 * 10**9


def group_streams(n_points=97):
    """96 series whose series-major lanes make 32-lane groups (warps) that
    are all int (mult 0..6), all float (a third of the values scaled to
    1e-40, which the f32 conversion flushes to zero), or mixed, then 16
    series with time-unit changes and annotations. 97 points: every series
    ends (EOS) inside its last chunk."""
    rng = np.random.default_rng(7)
    t = [T0 + j * 10**9 for j in range(n_points)]
    ints = [rng.integers(-5000, 5000, n_points) / 10 ** (i % 7) for i in range(40)]
    floats = [rng.normal(0, 1, n_points) * (1e-40 if i % 3 == 0 else 1e3) for i in range(40)]
    mixed = [x for pair in zip(ints[20:], floats[20:]) for x in pair]
    rows = ints[:20] + floats[:20] + mixed
    return [encode_series(t, [float(v) for v in r]) for r in rows] + synthetic_mixed_streams(
        16, n_points, seed=3, frac_float=0.3, frac_tu_change=0.4, frac_annotation=0.2)
