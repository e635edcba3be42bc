"""Streams shared by the port's kernel tests: the host-build tests on the
CPU (tests/test_torch_records.py, tests/test_torch_fields.py) and the card
tests (tests/test_torch_cuda.py) decode the same warp mixes; B-7's
host-build tests (tests/test_torch_temporal.py) and card tests take the
same validity patterns. Imports numpy and the port only, so the card tests
run without JAX."""

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


# f64 float points B-1 must carry bit for bit: NaNs (one with a payload),
# signed zeros, infinities, subnormals and the largest finite values
F64_SPECIALS = np.array([
    0x7FF8000000000000, 0x7FF0000000000123, 0xFFF8000000000001, 0x0000000000000000,
    0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000, 0x0000000000000001,
    0x800FFFFFFFFFFFFF, 0x7FEFFFFFFFFFFFFF, 0xFFEFFFFFFFFFFFFF, 0x3FF0000000000000,
], np.uint64).view(np.int64)


def consolidation_records(s, p, seed=0, step=10):
    """Decoded records [s, p] for the step-grid consolidation (kernel B-1)
    and a query over them: (records dict of numpy arrays ts int64, bits
    int64, point_is_float bool, mult uint8, valid bool; grid int64 [T];
    lo; hi; lookback). Timestamps are seconds on a 10 s lattice, so many
    steps fall exactly ``lookback`` after a record. Rows by index mod 6: no
    valid record; valid records only outside [lo, hi); runs of equal
    timestamps; and three of random gaps, some gaps past the lookback.
    Points mix float ones (``F64_SPECIALS`` and normal values) and int ones
    at every mult 0..6, negatives too; invalid records hold garbage
    timestamps."""
    rng = np.random.default_rng(seed)
    gaps = rng.choice([0, step, step, step, 2 * step, 7 * step], size=(s, p))
    gaps[:, 0] = rng.integers(0, 5, s) * step
    ts = T0 + np.cumsum(gaps, axis=1).astype(np.int64)
    kind = np.arange(s) % 6
    valid = rng.random((s, p)) < 0.85
    valid[kind == 0] = False
    span = int(ts.max() - T0) + step
    lo, hi = T0 + span // 8, T0 + span - span // 8
    out = (ts < lo) | (ts >= hi)
    valid[kind == 1] &= out[kind == 1]
    eq = kind == 2
    ts[eq] = T0 + (np.arange(p)[None, :] // 3 * step + lo - T0)
    ts = np.where(valid, ts, rng.integers(-(1 << 62), 1 << 62, (s, p)))
    pif = rng.random((s, p)) < 0.5
    fbits = np.where(rng.random((s, p)) < 0.3, rng.choice(F64_SPECIALS, (s, p)),
                     rng.normal(0, 1e3, (s, p)).view(np.int64))
    ibits = rng.integers(-10**9, 10**9, (s, p))
    bits = np.where(pif, fbits, ibits).astype(np.int64)
    mult = rng.integers(0, 7, (s, p)).astype(np.uint8)
    grid = T0 + np.arange(-3 * step, span + 4 * step, step, dtype=np.int64)
    records = dict(ts=ts.astype(np.int64), bits=bits, point_is_float=pif, mult=mult, valid=valid)
    return records, grid, lo, hi, 3 * step


def _lattice_records(ts_rows, valid_rows, seed):
    """Records over the given timestamp and valid rows (equal lengths), with
    the point mix of ``consolidation_records``: float points (some
    ``F64_SPECIALS``) and int points at every mult."""
    rng = np.random.default_rng(seed)
    ts = np.asarray(ts_rows, np.int64)
    valid = np.asarray(valid_rows, bool)
    shape = ts.shape
    ts = np.where(valid, ts, rng.integers(-(1 << 62), 1 << 62, shape))
    pif = rng.random(shape) < 0.5
    fbits = np.where(rng.random(shape) < 0.3, rng.choice(F64_SPECIALS, shape),
                     rng.normal(0, 1e3, shape).view(np.int64))
    bits = np.where(pif, fbits, rng.integers(-10**9, 10**9, shape)).astype(np.int64)
    mult = rng.integers(0, 7, shape).astype(np.uint8)
    return dict(ts=ts.astype(np.int64), bits=bits, point_is_float=pif, mult=mult, valid=valid)


CONSOLIDATION_CASES = ("equal_run_lane", "equal_run_tile", "repeated_steps", "grid_back",
                       "coarse_steps", "steps_1", "steps_31", "steps_33", "steps_77",
                       "empty_rows", "records_1", "records_past_tile")


def consolidation_case(name, seed=0, step=10):
    """One of B-1's adversarial inputs, as ``consolidation_records`` gives
    them (records, grid, lo, hi, lookback):

    - equal_run_lane: runs of 2-5 equal timestamps at the last step of
      every run of 4 steps (B-1's lane runs at T = 100), the next step with
      no record of its own, so a lane's first step picks the last of the run
      before it;
    - equal_run_tile: rows of 600 records with runs of 16 equal timestamps
      across records 256 and 512 (the boundaries of tiles of 256);
    - repeated_steps: every grid step three times;
    - grid_back: a grid that steps back, then runs backwards, then forwards;
    - coarse_steps: steps 4 record spacings apart and 7 off the records'
      lattice, wider than the lookback, so one step passes several records
      and the last of them decides the lookback test;
    - steps_1 / steps_31 / steps_33 / steps_77: grids of 1, 31, 33 and 77
      steps;
    - empty_rows: rows with no valid record (runs of them, and two of every
      five) between rows whose records are all counted, as the plan's
      padded rows are;
    - records_1: one record a row; records_past_tile: 257 records a row,
      one past a tile of 256."""
    lookback = 3 * step
    if name == "equal_run_lane":
        rows = []
        for r in range(8):
            ts = []
            for k in range(100):
                if k % 4 == 0 and k > 0:
                    continue  # the run before this step is its pick
                reps = 2 + (k // 4 + r) % 4 if k % 4 == 3 else 1
                ts += [T0 + k * step] * reps
            rows.append(ts[:300] + [ts[-1]] * (300 - len(ts[:300])))
        grid = T0 + np.arange(100, dtype=np.int64) * step
        rec = _lattice_records(rows, np.ones((8, 300), bool), seed)
        return rec, grid, T0 - step, T0 + 100 * step, lookback
    if name == "equal_run_tile":
        j = np.arange(600)
        idx = j.copy()
        idx[248:264] = 248
        idx[505:521] = 505
        ts = np.tile(T0 + idx * step, (6, 1))
        ts[1::2] += 5 * step  # half the rows shifted past a few steps
        grid = T0 + np.arange(-2, 620, dtype=np.int64) * step
        rec = _lattice_records(ts, np.ones((6, 600), bool), seed)
        return rec, grid, T0 - step, T0 + 700 * step, lookback
    if name.startswith("records_"):
        s, p = (20, 1) if name == "records_1" else (9, 257)
        return consolidation_records(s, p, seed=seed, step=step)
    if name == "empty_rows":
        s, p = 45, 300
        empty = (np.arange(s) % 5 >= 3) | ((np.arange(s) >= 20) & (np.arange(s) < 30))
        gaps = np.random.default_rng(seed).choice([step, step, 2 * step, 5 * step], (s, p))
        ts = T0 + np.cumsum(gaps, axis=1)
        valid = np.repeat(~empty[:, None], p, axis=1)
        grid = T0 + np.arange(0, int(gaps.sum(axis=1).max()) + 4 * step, step, dtype=np.int64)
        rec = _lattice_records(ts, valid, seed)
        return rec, grid, T0, T0 + (1 << 40), lookback
    rec, grid, lo, hi, lookback = consolidation_records(12, 150, seed=seed, step=step)
    if name == "repeated_steps":
        grid = np.repeat(grid, 3)
    elif name == "grid_back":
        grid = np.concatenate([grid[:40], grid[10:60][::-1], grid[25:]])
    elif name == "coarse_steps":
        grid = grid[::4] + 7 * step // 10
    elif name.startswith("steps_"):
        t = int(name.split("_")[1])
        mid = len(grid) // 3
        grid = grid[mid : mid + t]
    else:
        raise ValueError(f"no consolidation case {name!r}")
    return rec, grid, lo, hi, lookback


def b7_patterns(w, cols=97):
    """Rows whose validity reaches every path of B-7's staged route, named:
    the series starts (a NaN prefix), ends (a NaN suffix), has gaps, holds
    no sample, and the special values."""
    rng = np.random.default_rng(23)
    base = np.cumsum(rng.normal(1.0, 5.0, cols)).astype(np.float32)
    rows = {}
    for k in sorted({0, 1, w - 1, w + 5}):
        r = base.copy()
        r[:k] = np.nan
        rows[f"NaN prefix {k}"] = r
    for k in (1, 7, w + 3):
        r = base.copy()
        r[max(cols - k, 0):] = np.nan
        rows[f"NaN suffix {k}"] = r
    r = base.copy()
    r[::2] = np.nan
    rows["every other slot NaN"] = r
    rows["all NaN"] = np.full(cols, np.nan, np.float32)
    r = base.copy()
    r[:3] = np.nan
    r[40:47] = np.nan
    rows["a prefix and a gap"] = r
    r = base.copy()
    r[rng.random(cols) < 0.25] = np.nan
    rows["25% NaN"] = r
    pool = np.asarray([np.inf, -np.inf, 0.0, -0.0, 1.5, 1.5, -2.0, 3e38, -3e38, 1e-40],
                      np.float32)
    r = pool[rng.integers(0, len(pool), cols)]
    rows["specials"] = r.copy()
    r[:w // 2] = np.nan
    rows["specials after a NaN prefix"] = r
    rows["signed zeros"] = np.where(np.arange(cols) % 3, 0.0, -0.0).astype(np.float32)
    return list(rows), np.ascontiguousarray(np.stack(list(rows.values())))


def b4_lanes(name):
    """Encode lanes ((times int64[n], values float64[n]) pairs, each INT or
    FLOAT) at the edges of kernel B-4's steps of 32 records, named: lanes
    of 31 to 65 records and of 1 or 2 ("steps"), single records
    ("single"), one lane of 33 ("one_lane"), all INT, all FLOAT or
    alternating batches of ragged lanes, a step whose every record repeats
    and lanes that only repeat ("repeats"), int tracker falls whose five
    records straddle the step boundary at records 27-35, one interrupted by
    a raise, one by a mid, one to a sig of the step before, two in one step
    ("straddle"), and every dod
    opcode with both signs, the 32-bit one too ("opcodes")."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def times(n, steps=None):
        st = rng.integers(1, 30, n) if steps is None else np.asarray(steps, np.int64)
        return (T0 + np.cumsum(st) * 10**9).astype(np.int64)

    def ints(n):
        return rng.integers(-5000, 5000, n).astype(np.float64)

    def floats(n):
        return rng.normal(0, 10, n)

    def ragged(kinds, m, n_max):
        return [(times(n), kinds(i)(n)) for i, n in enumerate(rng.integers(1, n_max, m))]

    if name == "steps":
        return [(times(n), (ints if i % 2 else floats)(n))
                for i, n in enumerate([31, 32, 33, 63, 64, 65, 1, 2, 32, 33, 96, 97])]
    if name == "single":
        vals = [0.0, -3.0, 7.0, 2.0**31 - 1, -(2.0**31 - 1), np.pi, np.nan, np.inf, -np.sqrt(2), 1e300]
        return [(times(1), np.asarray([v])) for v in vals * 4]
    if name == "one_lane":
        return [(times(33), ints(33))]
    if name == "all_int":
        return ragged(lambda i: ints, 100, 300)
    if name == "all_float":
        return ragged(lambda i: floats, 100, 300)
    if name == "alternating":
        return ragged(lambda i: ints if i % 2 else floats, 100, 300)
    if name == "repeats":
        out = []
        for kind, const in ((ints, 42.0), (floats, np.e)):
            v = kind(100)
            v[32:64] = v[31]  # records 32-63, a whole step, repeat
            out += [(times(100), v), (times(100, np.full(100, 10)), v.copy()),
                    (times(70), np.full(70, const)), (times(32), np.full(32, const))]
        return out
    if name == "straddle":
        out = []
        for start in range(27, 32):  # the fifth low is record start + 4: 31 .. 35
            d = rng.integers(3000, 5000, 80) * rng.choice([-1, 1], 80)
            d[start:start + 5] = rng.integers(1, 4, 5)
            out.append((times(80), np.cumsum(d).astype(np.float64)))
        d = rng.integers(3000, 5000, 80)
        d[29:35] = [2, 3, 9000, 1, 2, 3]  # a raise inside the run does not end it
        out.append((times(80), np.cumsum(d).astype(np.float64)))
        d = rng.integers(3000, 5000, 80)
        d[29:36] = [2, 3, 1, 4000, 1, 2, 3]  # a mid record ends the run
        out.append((times(80), np.cumsum(d).astype(np.float64)))
        d = rng.integers(5000, 9000, 80)
        d[29:32] = 900  # the run's largest sig (10) in the step before its fall
        d[32:34] = 2
        out.append((times(80), np.cumsum(d).astype(np.float64)))
        d = rng.integers(3000, 5000, 80)
        d[32:37] = 1  # two falls in one step: to 1 bit, back up, down again
        d[37] = 40
        d[38:43] = 2
        out.append((times(80), np.cumsum(d).astype(np.float64)))
        return out
    if name == "opcodes":
        dods = [0, 5, -60, 63, -64, 200, -250, 255, -256, 1500, -2000, 2047, -2048, 100000,
                -99990, 3, 0, 1, 2**20, -(2**20)]
        deltas = np.abs(np.cumsum(np.asarray(dods * 4, np.int64))) + 1
        n = len(deltas)
        return [(times(n, deltas), ints(n)), (times(n, deltas), floats(n)),
                (times(n, deltas[::-1]), ints(n)), (times(n, deltas[::-1]), floats(n))]
    raise ValueError(name)
