"""The port's aggregator tier (``m3_tpu_torch/aggregator/``) against
``m3_tpu``'s on the CPU.

- B-5a's and B-5b's twins (``kernels.aggregate_dense`` /
  ``dense_quantiles`` on CPU tensors) equal ``m3_tpu``'s XLA programs bit
  for bit at P = 1, 6, 33 and 1,000 slots, on empty rows, tied time orders,
  signed zeros, subnormals and infinities, and at the 20,000 datapoints
  into 700 groups of ``tests/test_aggregation.py``; on wide rows of a few
  valid slots (valid prefixes, or scattered across the window tree),
  n = 32 and 33 valid slots, picks on valid NaNs, last's INT32_MIN tie
  with an invalid slot 0, and sums that flush to -0 before skipped slots
  or at a last window's last item (no padding is added behind it).
  One stated exception: on subnormal inputs the reference's min and max
  leave some rows unflushed (XLA's vectorized code), so there the twin is
  held to the reference's values flushed.
- ``rollup.cu`` built as host C++ equals the twins bit for bit on every
  route (the tile route, a lane's and a warp's wide rows, the long rows'
  select, in shared memory and past it).
- ``window_keys`` and ``pack_dense_groups`` equal the reference's outputs.
- The port's ``Aggregator`` (``device="cpu"``) flushes the same metrics as
  ``m3_tpu``'s (id, window end, type, policy, value bits) on the scenarios
  of ``tests/test_aggregator.py`` and ``test_aggregator_entries.py`` and on
  a seeded mix of counters, gauges and timers; ``QuantileStream`` answers
  as the reference's on ``tests/test_r2_collector.py``'s streams.
"""

import ctypes
import math
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from m3_tpu.aggregator import aggregator as jagg
from m3_tpu.aggregator import kernels as jk
from m3_tpu.aggregator import quantile_cm as jcm
from m3_tpu.metrics import policy as jpol
from m3_tpu.metrics import types as jtypes
from m3_tpu_torch.aggregator import aggregator as tagg
from m3_tpu_torch.aggregator import kernels as tk
from m3_tpu_torch.aggregator import quantile_cm as tcm
from m3_tpu_torch.metrics import policy as tpol
from m3_tpu_torch.metrics import types as ttypes
from m3_tpu_torch.ops import _build

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
QS = (0.1, 0.5, 0.95, 0.99, 0.999, 0.9999)
_TINY = np.finfo(np.float32).tiny
_I32_MIN = np.iinfo(np.int32).min


def _flushed(x):
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < _TINY, np.copysign(np.float32(0), x), x).astype(np.float32)


def _same_bits(a, b) -> bool:
    """Equal f32 bits, NaN in the same places (any payload)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool(
        ((a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))).all())


def _case(name):
    """(vals, torder, valid) f32/i32/bool [G, P], seeded."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "aggregation_20000x700":
        # tests/test_aggregation.py:169's inputs, packed as the flush packs them
        keys = rng.integers(0, 700, 20_000).astype(np.int32)
        vals = rng.lognormal(0, 1, 20_000).astype(np.float32)
        torder = rng.integers(0, 50, 20_000).astype(np.int32)
        return tk.pack_dense_groups(keys, vals, torder, 700)
    kind, p, g = name.split("-")
    p, g = int(p), int(g)
    vals = (rng.lognormal(0, 1, (g, p)) * np.where(rng.random((g, p)) < 0.5, 1, -1)).astype(
        np.float32)
    valid = rng.random((g, p)) < 0.8
    torder = rng.integers(0, 1000, (g, p)).astype(np.int32)
    valid[: max(g // 10, 1)] = False  # empty rows
    if kind == "ties":
        torder = rng.integers(0, 3, (g, p)).astype(np.int32)
    elif kind == "zeros":
        roll = rng.random((g, p))
        vals[roll < 0.3] = 0.0
        vals[(roll >= 0.3) & (roll < 0.6)] = -0.0
    elif kind == "subnormal":
        roll = rng.random((g, p))
        vals[roll < 0.2] = 1e-40
        vals[(roll >= 0.2) & (roll < 0.3)] = -3e-39
        vals[(roll >= 0.3) & (roll < 0.4)] = 1e-20  # its square flushes
        vals[(roll >= 0.4) & (roll < 0.5)] = -0.0
    elif kind == "inf":
        roll = rng.random((g, p))
        vals[roll < 0.15] = np.inf
        vals[(roll >= 0.15) & (roll < 0.2)] = -np.inf
        vals[(roll >= 0.2) & (roll < 0.25)] = 3e38  # squares overflow
        vals[rng.random(g) < 0.2] = np.inf  # rows of +inf: inf - inf in the quantiles
    elif kind == "nan":
        vals[rng.random((g, p)) < 0.1] = np.nan  # NaN in valid slots propagates
    elif kind == "prefix":
        # the packer's layout of a shard widened by one batching timer: each
        # row's valid slots first (1 to 8 of them), the last row full
        valid = np.arange(p) < rng.integers(0, 9, g)[:, None]
        valid[-1] = True
    elif kind == "scattered":
        # a few valid slots anywhere, across the tree's window boundaries,
        # some NaN (picks past the non-NaN values: +inf for the invalid slots)
        valid = rng.random((g, p)) < rng.integers(1, 41, g)[:, None] / p
        vals[rng.random((g, p)) < 0.2] = np.nan
    elif kind in ("count32", "count33"):
        # exactly 32 or 33 valid slots: either side of the short rows' limit
        valid = np.zeros((g, p), bool)
        for row in valid:
            row[rng.choice(p, int(kind[-2:]), replace=False)] = True
        vals[rng.random((g, p)) < 0.05] = np.nan
    elif kind == "nanpick":
        # valid NaNs outnumber the invalid slots: high ranks pick a NaN
        valid = rng.random((g, p)) < 0.9
        vals[rng.random((g, p)) < 0.7] = np.nan
    elif kind == "tmin":
        # a valid slot of time order INT32_MIN after an invalid slot 0: it
        # ties with the invalid slots, and last is slot 0's +0
        valid[:, 0] = rng.random(g) < 0.3
        torder[rng.random((g, p)) < 0.7] = _I32_MIN
        torder[g // 2:] = _I32_MIN
    elif kind == "negzero":
        vals, valid = _negzero_rows(p, g, rng)
    return vals, torder, valid


def _negzero_rows(p, g, rng, back_padding=False):
    """Rows whose valid sums flush to -0 before invalid slots (or windows
    without a valid slot): the reference then adds +0, which turns the -0
    to +0. Each pattern at each place of the tree, then random rows. With
    back_padding, only the rows whose sum is -0 where a last window's sum
    flushes to -0 at its last item: the reference adds no padding behind
    it, so the -0 stays."""
    lo = (-(-p // 32) * 32 - p) // 2
    starts = [max(32 * w - lo, 0) for w in range(-(-p // 32))]  # each level-0 window's first slot
    a, b = np.float32(-1.5e-38), np.float32(1.4e-38)  # a + b flushes to -0
    rows = [{0: a, 1: b},  # then invalid slots to the end
            {0: a, 1: b, p - 1: -0.0}]  # then invalid slots, then a valid -0
    ends = []  # rows whose sum is -0, a last window's -0 at its last item (padded behind or not)
    if len(starts) >= 3:  # two windows' sums flush to -0, then:
        last = starts[-1]
        rows += [{starts[0]: a, starts[1]: b, last: a, last + 1: b},  # invalid slots to its end
                 {starts[0]: a, starts[1]: b},  # windows without a valid slot to the end
                 {starts[0]: a, starts[1]: b, last: a, last + 1: b, p - 1: -0.0}]  # then a -0
        # (windows between without a valid slot) the last window's -0 at the row's last
        # slot: the sum stays -0 where the windows' sums are the last level's items
        row = {starts[0]: a, starts[1]: b, p - 2: a, p - 1: b}
        (ends if len(starts) <= 32 else rows).append(row)
        if len(starts) <= 32:  # the same with every slot valid (more than 32: a lane a window)
            ends.append({**{j: np.float32(-0.0) for j in range(p)},
                         starts[0]: a, starts[1]: b, last: a, last + 1: b})
    if len(starts) > 64:  # three levels: level 1's last window's -0 at its last item too
        m = len(starts)
        lo1 = (-(-m // 32) * 32 - m) // 2
        first1 = [max(32 * w - lo1, 0) for w in range(-(-m // 32))]  # each one's first window
        ends.append({starts[first1[0]]: a, starts[first1[1]]: b, starts[m - 3]: a,
                     starts[m - 2]: b, p - 2: a, p - 1: b})
    rows += ends
    if p % 32 == 0 and len(starts) >= 4:  # more than 32 valid slots (a lane a window): the
        # first window filled with valid -0 (its sum stays a), the third's sum flushes to -0
        w0 = {j: np.float32(-0.0) for j in range(1, 32)}
        w2 = {64: a, 65: b, **{j: np.float32(-0.0) for j in range(66, 96)}}
        rows += [{**w0, 0: a, 32: b, **w2, 96: a, 97: b, 127: -0.0},  # a skip, then -0
                 {**w0, 0: a, 32: b, 64: a, 65: b,  # invalid slots to its window's end,
                  **{j: np.float32(-0.0) for j in range(98, 128)}, 96: a, 97: b}]  # then a -0
    if back_padding:
        rows = ends
    vals = np.where(rng.random((g, p)) < 0.5, np.float32(1e-39), np.float32(-0.0))
    vals = vals.astype(np.float32)
    valid = rng.random((g, p)) < 0.3
    for i, row in enumerate(rows[:g]):
        valid[i] = False
        for j, x in row.items():
            vals[i, j], valid[i, j] = x, True
    return vals, valid


CASES = ["plain-1-60", "plain-6-700", "plain-33-64", "plain-1000-7", "plain-2100-5",
         "ties-6-300", "ties-40-50", "zeros-1-200", "zeros-6-300", "zeros-45-40",
         "subnormal-1-300", "subnormal-6-300", "subnormal-33-60", "inf-1-100", "inf-6-300",
         "inf-70-30", "nan-6-100", "nan-33-30", "aggregation_20000x700",
         "prefix-1000-300", "scattered-100-200", "scattered-1100-40", "count32-1000-20",
         "count33-1000-20", "nanpick-20-60", "nanpick-40-60", "tmin-6-100", "tmin-40-100",
         "negzero-20-30", "negzero-70-30", "negzero-128-30", "negzero-1100-20",
         "negzero-2100-20"]


@pytest.mark.parametrize("name", CASES)
def test_b5a_twin_matches_reference(name):
    vals, torder, valid = _case(name)
    want = jk.aggregate_dense(vals, torder, valid)
    got = tk.aggregate_dense(torch.from_numpy(vals), torch.from_numpy(torder),
                             torch.from_numpy(valid))
    for f in tk.FIELDS:
        w, o = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if name.startswith("subnormal") and f in ("min", "max") and vals.shape[1] > 1:
            w = _flushed(w)  # the stated exception (module docstring)
        assert _same_bits(o, w), f


def test_b5a_traps():
    """The reference's traps, one row each: slot-order sums, last of -0 is
    +0, min/max order -0 below +0, squares flush, empty rows."""
    vals = np.array([[0.0, -0.0, np.nan], [-0.0, -0.0, np.nan], [1e-20, 3e-20, np.nan],
                     [np.nan] * 3, [5.0, 7.0, 5.0]], np.float32)
    valid = ~np.isnan(vals)
    torder = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [3, 1, 3]], np.int32)
    got = tk.aggregate_dense(vals, torder, valid)
    want = jk.aggregate_dense(vals, torder, valid)
    for f in tk.FIELDS:
        assert _same_bits(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    assert np.signbit(got.min[0].item()) and not np.signbit(got.max[0].item())
    assert not np.signbit(got.last[1].item())  # the dense path's +0
    assert got.sum_sq[2] == 0 and got.stdev[2] == 0
    assert got.sum[3] == 0 and got.count[3] == 0 and math.isnan(got.last[3])
    assert got.last[4] == 5.0  # first slot wins the tie at torder 3


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("qs", [(0.5,), QS, (0.0, 1.0)])
def test_b5b_twin_matches_reference(name, qs):
    vals, _, valid = _case(name)
    want = np.asarray(jk.dense_quantiles(vals, valid, qs))
    got = tk.dense_quantiles(torch.from_numpy(vals), torch.from_numpy(valid), qs).numpy()
    assert _same_bits(got, want)


def test_b5b_inf_pairs_give_nan():
    """Two valid +inf picks give inf + (inf - inf) * frac = NaN, and so
    does inf * 0 where only the upper pick is +inf."""
    vals = np.array([[np.inf, np.inf, 1.0], [1.0, 2.0, np.inf], [1.0, 2.0, 3.0]], np.float32)
    valid = np.ones_like(vals, bool)
    got = tk.dense_quantiles(vals, valid, (0.99, 0.5)).numpy()
    want = np.asarray(jk.dense_quantiles(vals, valid, (0.99, 0.5)))
    assert _same_bits(got, want)
    assert math.isnan(got[0, 0]) and math.isnan(got[1, 1]) and got[1, 2] == 2.0


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="quantiles"):
        tk.dense_quantiles(np.zeros((2, 3), np.float32), np.ones((2, 3), bool), ())
    for q in (-0.1, 1.5, float("nan")):
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            tk.dense_quantiles(np.zeros((2, 3), np.float32), np.ones((2, 3), bool), (0.5, q))
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            tk.launch_dense_quantiles(torch.zeros((2, 3)), torch.ones((2, 3), dtype=torch.bool),
                                      (q,))
    with pytest.raises(ValueError, match=r"\[G, P\]"):
        tk.aggregate_dense(np.zeros((2, 3), np.float32), np.zeros((2, 4), np.int32),
                           np.ones((2, 3), bool))
    with pytest.raises(ValueError, match="card"):  # a launch takes tensors on a card only
        tk.launch_aggregate_dense(torch.zeros((2, 3)), torch.zeros((2, 3), dtype=torch.int32),
                                  torch.ones((2, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="card"):
        tk.launch_dense_quantiles(torch.zeros((2, 3)), torch.ones((2, 3), dtype=torch.bool),
                                  (0.5,))


@pytest.fixture(scope="module")
def host_rollup(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "rollup_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["rollup"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.m3_aggregate_dense_host.argtypes = [P, P, P, I64, I64, P]
    lib.m3_dense_quantiles_host.argtypes = [P, P, I64, I64, P, I, I64, P]
    return lib


@pytest.mark.parametrize("name", CASES)
def test_b5_host_build_matches_twin(host_rollup, name):
    vals, torder, valid = (np.ascontiguousarray(a) for a in _case(name))
    g, p = vals.shape
    ok = valid.view(np.uint8)
    out = np.zeros((8, g), np.float32)
    assert host_rollup.m3_aggregate_dense_host(vals.ctypes.data, torder.ctypes.data,
                                               ok.ctypes.data, g, p, out.ctypes.data) == 0
    assert _same_bits(out, tk.aggregate_dense_fields(vals, torder, valid).numpy())
    want = tk.dense_quantiles(vals, valid, QS).numpy()
    qs = (ctypes.c_float * len(QS))(*QS)
    q = np.zeros((len(QS), g), np.float32)
    assert host_rollup.m3_dense_quantiles_host(vals.ctypes.data, ok.ctypes.data, g, p, qs,
                                               len(QS), 0, q.ctypes.data) == 0
    assert _same_bits(q, want)


@pytest.mark.parametrize("p, k", [(70, 2), (2100, 1)])
def test_b5a_host_build_matches_twin_at_back_padding(host_rollup, p, k):
    """Rows whose last window's sum flushes to -0 at the row's last slot:
    the reference adds no padding behind it, and its -0 sum stays; the
    host build and the twin give the same."""
    vals, valid = (np.ascontiguousarray(a)
                   for a in _negzero_rows(p, 20, np.random.default_rng(p), back_padding=True))
    torder = np.zeros(vals.shape, np.int32)
    out = np.zeros((8, 20), np.float32)
    assert host_rollup.m3_aggregate_dense_host(vals.ctypes.data, torder.ctypes.data,
                                               valid.view(np.uint8).ctypes.data, 20, p,
                                               out.ctypes.data) == 0
    assert _same_bits(out, tk.aggregate_dense_fields(vals, torder, valid).numpy())
    assert _same_bits(out[0], np.asarray(jk.aggregate_dense(vals, torder, valid).sum))
    assert np.signbit(out[0, :k]).all() and (out[0, :k] == 0).all()  # the reference's -0


@pytest.mark.parametrize("name", ["plain-1000-7", "plain-2100-5", "prefix-1000-300",
                                  "count33-1000-20", "nanpick-40-60", "inf-70-30"])
def test_b5b_host_build_selects_past_shared_memory(host_rollup, name):
    """Rows with more keys than the long route's shared memory holds select
    on keys read again from the row each pass (a capacity of 20 keys here)."""
    vals, _, valid = (np.ascontiguousarray(a) for a in _case(name))
    g, p = vals.shape
    assert int(valid.sum(1).max()) > 32
    qs = (ctypes.c_float * len(QS))(*QS)
    q = np.zeros((len(QS), g), np.float32)
    assert host_rollup.m3_dense_quantiles_host(vals.ctypes.data, valid.view(np.uint8).ctypes.data,
                                               g, p, qs, len(QS), 20, q.ctypes.data) == 0
    assert _same_bits(q, tk.dense_quantiles(vals, valid, QS).numpy())


def test_window_keys_match():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 5000, 4000).astype(np.int32)
    times = T0 + rng.integers(0, 600 * NANOS, 4000)
    for res, n_windows in ((10 * NANOS, 60), (60 * NANOS, 10), (NANOS // 1000, 600_000_000)):
        got = tk.window_keys(ids, times, T0, res, n_windows)
        want = jk.window_keys(ids, times, T0, res, n_windows)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # the i64 key case: id * n_windows past INT32_MAX
    big = tk.window_keys(ids, times, T0, NANOS // 1000, 600_000_000)[0]
    assert big.dtype == np.int64


def test_pack_dense_groups_matches():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 300, 5000).astype(np.int32)
    vals = rng.normal(0, 1, 5000).astype(np.float32)
    vals[::37] = np.nan
    torder = rng.integers(0, 9, 5000).astype(np.int32)
    for k in (keys, keys.astype(np.int64) + 2**31):
        n = int(k.max()) + 1 if k.dtype == np.int32 else None
        if n is None:
            k = k - 2**31  # i64 keys of the same groups
            n = 300
        for a, b in zip(tk.pack_dense_groups(k, vals, torder, n),
                        jk.pack_dense_groups(k, vals, torder, n)):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


# --- the Aggregator ---


def _pol(pkg, s):
    return pkg.StoragePolicy.parse(s)


def _flat(metrics):
    return [(m.id, m.time_nanos, int(m.agg_type), str(m.policy),
             "nan" if math.isnan(m.value) else np.float64(m.value).tobytes())
            for m in metrics]


def _pair(**kw):
    """A reference and a port Aggregator with the same options."""
    pols = kw.pop("policies", ("10s:2d",))
    j = jagg.Aggregator(default_policies=tuple(_pol(jpol, p) for p in pols), **kw)
    t = tagg.Aggregator(default_policies=tuple(_pol(tpol, p) for p in pols), device="cpu", **kw)
    return j, t


def _both(j, t, fn):
    fn(j, jtypes, jpol)
    fn(t, ttypes, tpol)


def test_aggregator_end_to_end_matches():
    """tests/test_aggregator.py:103-160's scenario."""
    j, t = _pair(num_shards=4)

    def feed(agg, types, pol):
        for s, v in [(1, 3), (4, 7), (12, 5)]:
            agg.add_untimed(types.Untimed(types.MetricType.COUNTER, b"requests", counter_value=v),
                            time_nanos=T0 + s * NANOS)
        agg.add_untimed(types.Untimed(types.MetricType.GAUGE, b"temp", gauge_value=99.0),
                        time_nanos=T0 + 8 * NANOS)
        agg.add_untimed(types.Untimed(types.MetricType.GAUGE, b"temp", gauge_value=55.0),
                        time_nanos=T0 + 2 * NANOS)
        agg.add_untimed(types.Untimed(types.MetricType.TIMER, b"latency",
                                      batch_timer_values=[1.0, 2.0, 3.0, 4.0, 100.0]),
                        time_nanos=T0 + 5 * NANOS)

    _both(j, t, feed)
    got, want = t.flush(T0 + 20 * NANOS), j.flush(T0 + 20 * NANOS)
    assert _flat(got) == _flat(want) and len(got) > 10
    assert {m.suffixed_id for m in got} == {m.suffixed_id for m in want}
    _both(j, t, lambda agg, types, pol: agg.add_timed(b"requests", types.MetricType.COUNTER,
                                                       T0 + 25 * NANOS, 2.0))
    assert _flat(t.flush(T0 + 40 * NANOS)) == _flat(j.flush(T0 + 40 * NANOS))


def _gauge(types, mid, v):
    return types.Untimed(id=mid, type=types.MetricType.GAUGE, gauge_value=v)


def test_rate_limit_matches():
    j, t = _pair(num_shards=2, value_rate_limit=2.0)

    def feed(agg, types, pol):
        for i in range(5):
            agg.add_untimed(_gauge(types, b"noisy", float(i)), 1000 * NANOS,
                            aggregations=(types.AggregationType.COUNT,))
        agg.add_untimed(_gauge(types, b"b", 3.0), 1000 * NANOS,
                        aggregations=(types.AggregationType.COUNT,))

    _both(j, t, feed)
    assert _flat(t.flush(1020 * NANOS)) == _flat(j.flush(1020 * NANOS))
    assert t.rate_limited == j.rate_limited == 3
    _both(j, t, lambda agg, types, pol: agg.add_untimed(_gauge(types, b"noisy", 9.0),
                                                        1030 * NANOS))
    assert _flat(t.flush(1050 * NANOS)) == _flat(j.flush(1050 * NANOS))


def test_ttl_expiry_and_overrides_match():
    """test_aggregator_entries.py's TTL, pending-buffer and override-remap
    scenarios in one sequence."""
    j, t = _pair(num_shards=1, entry_ttl_nanos=60 * NANOS)
    steps = [
        (0, [(b"dead", 1.0, None), (b"old", 1.0, None), (b"kept", 5.0, "MAX")], 20),
        (100, [(b"kept", 9.0, "MAX"), (b"fresh", 3.0, None)], 120),
        (130, [(b"kept", 4.0, None), (b"old", 7.0, None)], 150),
        (200, [(b"x", 1.0, None)], 0),
        (295, [(b"x", 2.0, None)], 290),
    ]
    for at, writes, flush_at in steps:
        def feed(agg, types, pol, at=at, writes=writes):
            for mid, v, over in writes:
                aggs = (types.AggregationType[over],) if over else None
                agg.add_untimed(_gauge(types, mid, v), 1000 * NANOS + at * NANOS,
                                aggregations=aggs)
        _both(j, t, feed)
        if flush_at:
            assert _flat(t.flush((1000 + flush_at) * NANOS)) == _flat(
                j.flush((1000 + flush_at) * NANOS))
            assert [s.ids for s in t.shards] == [s.ids for s in j.shards]
    assert t.expired_entries == j.expired_entries >= 1


def test_passthrough_matches():
    got_j, got_t = [], []
    j = jagg.Aggregator(num_shards=2, flush_handler=got_j.extend)
    t = tagg.Aggregator(num_shards=2, flush_handler=got_t.extend, device="cpu")
    j.add_passthrough(b"svc.p99", T0, 123.0, _pol(jpol, "1m:40d"), jtypes.AggregationType.P99)
    t.add_passthrough(b"svc.p99", T0, 123.0, _pol(tpol, "1m:40d"), ttypes.AggregationType.P99)
    assert _flat(got_t) == _flat(got_j) and t.passthrough_count == 1
    assert t.flush(2 * T0) == [] and j.flush(2 * T0) == []


def test_undelivered_output_retries_at_next_flush():
    """Standalone mode keeps windows the handler refused and sends them
    first at the next flush, as the reference does."""
    fail = [True]

    def handler(sent, out):
        if fail[0]:
            raise ConnectionError("downstream down")
        out.extend(sent)

    outs = {"j": [], "t": []}
    j = jagg.Aggregator(num_shards=2, flush_handler=lambda m: handler(m, outs["j"]))
    t = tagg.Aggregator(num_shards=2, flush_handler=lambda m: handler(m, outs["t"]),
                        device="cpu")
    _both(j, t, lambda agg, types, pol: agg.add_timed(b"m", types.MetricType.COUNTER,
                                                       T0, 2.0))
    for agg in (j, t):
        with pytest.raises(ConnectionError):
            agg.flush(T0 + 20 * NANOS)
    fail[0] = False
    _both(j, t, lambda agg, types, pol: agg.add_timed(b"m", types.MetricType.COUNTER,
                                                       T0 + 20 * NANOS, 3.0))
    j.flush(T0 + 40 * NANOS)
    t.flush(T0 + 40 * NANOS)
    assert _flat(outs["t"]) == _flat(outs["j"]) and len(outs["t"]) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_traffic_matches(seed):
    """Counters, gauges and timers (default aggregations and overrides) over
    two policies and several windows, written out of order in batches."""
    rng = np.random.default_rng(seed)
    n_metrics, n_rows = 300, 4000
    kinds = rng.integers(1, 4, n_metrics)
    over = {i: (ttypes.AggregationType.P999, ttypes.AggregationType.MIN)
            for i in range(0, n_metrics, 17)}
    rows_t, rows_j = [], []
    pols = ("10s:2d", "1m:40d")
    for _ in range(n_rows):
        i = int(rng.integers(0, n_metrics))
        ts = T0 + int(rng.integers(0, 180 * NANOS))
        v = float(np.float32(rng.lognormal(0, 2) * (1 if rng.random() < 0.8 else -1)))
        pick = pols[: 1 + (i % 2)]
        for rows, types, pol in ((rows_t, ttypes, tpol), (rows_j, jtypes, jpol)):
            aggs = over.get(i)
            if aggs is not None:
                aggs = tuple(types.AggregationType(int(a)) for a in aggs)
            rows.append((f"m{i}".encode(), types.MetricType(int(kinds[i])), ts, v,
                         tuple(_pol(pol, p) for p in pick), aggs))
    j, t = _pair(num_shards=3)
    for k in range(0, n_rows, 1000):
        j.add_timed_batch(rows_j[k:k + 1000])
        t.add_timed_batch(rows_t[k:k + 1000])
        if k == 2000:
            assert _flat(t.flush(T0 + 95 * NANOS)) == _flat(j.flush(T0 + 95 * NANOS))
    got, want = t.flush(T0 + 400 * NANOS), j.flush(T0 + 400 * NANOS)
    assert _flat(got) == _flat(want) and len(got) > 1000
    assert t.stage_seconds["densify"] > 0 and t.stage_seconds["emit"] > 0


def test_replication_raises_naming_a10():
    for kw in ({"election": object()}, {"flush_times": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP §A10"):
            tagg.Aggregator(device="cpu", **kw)


def test_aggregator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tagg.Aggregator()
    assert tagg.Aggregator(device="cpu").device.type == "cpu"


# --- QuantileStream (tests/test_r2_collector.py:108-160's streams) ---


def _streams():
    rng = np.random.default_rng(5)
    yield "normal", (0.5, 0.95, 0.99), 0.01, rng.normal(100.0, 15.0, 20_000)
    rng = np.random.default_rng(11)
    data = np.concatenate([rng.normal(10.0, 1.0, 25_000), rng.normal(1000.0, 5.0, 25_000)])
    rng.shuffle(data)
    yield "bimodal", (0.5, 0.95, 0.99), 0.01, data
    yield "descending", (0.5, 0.99), 0.01, np.arange(50_000, 0, -1, dtype=np.float64)


@pytest.mark.parametrize("which", ["normal", "bimodal", "descending"])
def test_quantile_stream_matches(which):
    _, targets, eps, data = next(s for s in _streams() if s[0] == which)
    a, b = jcm.QuantileStream(targets, eps), tcm.QuantileStream(targets, eps)
    for v in data:
        a.insert(float(v))
        b.insert(float(v))
    for q in targets:
        assert b.query(q) == a.query(q)
    assert (b.num_samples, b.min(), b.max()) == (a.num_samples, a.min(), a.max())


def test_quantile_stream_edge_cases():
    qs = tcm.QuantileStream(quantiles=(0.5,))
    assert math.isnan(qs.query(0.5))
    qs.insert(7.0)
    assert qs.query(0.5) == 7.0
    for bad in ((), (0.0,), (1.0,)):
        with pytest.raises(ValueError):
            tcm.QuantileStream(quantiles=bad)
