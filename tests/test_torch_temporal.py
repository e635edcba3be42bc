"""Port parity for the temporal functions and kernel B2.

- Every FUSABLE twin (m3_tpu_torch.query.functions.temporal) equals the jnp
  formula of m3_tpu/query/functions/temporal.py within 1e-5 abs + 1e-5 rel,
  with an identical NaN pattern. This is how the JAX package's own tests
  run B2 on the CPU: ``fused_temporal`` falls back to these formulas
  off-TPU.
- B2's source, compiled as host C++, equals the twin within the
  reference's stated bound (1e-4 abs + 1e-4 rel; 5e-3 abs for stddev/stdvar,
  TOLERANCE.md), with an identical NaN pattern; every function but
  stddev/stdvar bit for bit, since the kernel runs the reference's doubling
  tree. Each one-function specialisation and the all-function kernel are
  held separately, at windows up to one longer than the row.

Inputs: 96 series x 120 points made with numpy from a seed. "gauge" rows
are stationary (N(50, 5)) with 8% NaN, an all-NaN row, a sparse row and a
row that starts late; "counter" rows are monotone with resets. The
stddev/stdvar formula (E[x^2] - mean^2 about the row's mean) is
ill-conditioned on trending rows, where any change of summation order
moves it beyond the bound (TOLERANCE.md: "degraded when stddev << |mean|"),
so those two are held on the gauge rows only.

Kernel B-7 (``temporal_window.py``: deriv, predict_linear, holt_winters,
quantile_over_time):

- Its twin (``temporal.py``) equals m3_tpu's functions within 1e-4 abs +
  1e-4 rel with an identical NaN pattern (infinities equal) on the data of
  tests/test_temporal.py (7 x 60, 25% NaN, an empty row, a strided row),
  at windows 1, 5, 16 and 61 (longer than the row), q in {-0.5, 0, 0.5,
  0.9, 1, 1.5}, and a chunk of 16 (not a divisor of 60) beside the default.
  The twin folds each window in slot order, the reference's XLA sums in
  its own: the linear regression differs by at most 4.9e-6 abs on deriv
  and 3.1e-3 abs on predict_linear values of ~1e3 here (measured).
- B-7's source, compiled as host C++, equals the twin bit for bit on the
  same data and on rows of infinities, signed zeros and repeated values,
  at quantile runs of 1, 3, 100 and the kernel's own, through the staged
  route and the device-memory route.
- The host build equals the twin, sliced at ``first``, bit for bit on rows
  whose validity reaches every path of the staged route (fully valid rows,
  a NaN prefix of 0, 1, W-1 and more than W columns, NaN suffixes, every
  other slot NaN, all NaN, a gap, 25% NaN, the specials), at W = 1, 2, 3,
  31, 61 and 200 (longer than the row) and first = 0, W-1 and T-1.
- ``temporal_window(..., first=k)`` on the CPU is the twin's output sliced
  at k, and the port's Engine equals the JAX Engine on B-7 queries over
  series that start late, stop early or have gaps.
"""

import ctypes
import shutil
import subprocess
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.query.functions import temporal as jt
from m3_tpu.query.functions import temporal_fused as jtf
from m3_tpu_torch.ops import _build
from m3_tpu_torch.query.functions import temporal_fused as TF
from m3_tpu_torch.query.functions import temporal_window as TW
from torch_streams import b7_patterns

WINDOWS = [1, 5, 7, 200]
STEP = 10.0


def _data(kind):
    rng = np.random.default_rng(7 if kind == "gauge" else 8)
    if kind == "gauge":
        v = rng.normal(50, 5, (96, 120)).astype(np.float32)
        v[rng.random(v.shape) < 0.08] = np.nan
        v[3] = np.nan
        v[4, rng.random(120) < 0.9] = np.nan
        v[5, :70] = np.nan
        return v
    v = np.cumsum(rng.integers(0, 20, (96, 120)), axis=1).astype(np.float32)
    resets = rng.random(v.shape) < 0.03
    v = np.where(np.cumsum(resets, axis=1) % 2 == 1, v * 0.01, v).astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.nan
    v[7, 1::2] = np.nan
    return v


CASES = [(kind, name) for kind in ("gauge", "counter") for name in sorted(TF.FUSABLE)
         if kind == "gauge" or not name.startswith("std")]


def _assert_close(got, want, atol, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN pattern differs"
    m = ~np.isnan(want)
    bad = np.abs(got[m] - want[m]) > atol + rtol * np.abs(want[m])
    assert not bad.any(), f"{what}: {bad.sum()} beyond bound, e.g. {got[m][bad][:3]} vs {want[m][bad][:3]}"


@pytest.mark.parametrize("kind,name", CASES)
def test_twin_matches_jnp(kind, name):
    v = _data(kind)
    for w in WINDOWS:
        want = jtf.FUSABLE[name](jnp.asarray(v), w, STEP)
        got = TF.FUSABLE[name](torch.from_numpy(v), w, STEP)
        assert got.dtype == torch.float32
        _assert_close(got.numpy(), want, 1e-5, 1e-5, f"{name} w={w}")


def test_fused_temporal_multi_output_order():
    v = torch.from_numpy(_data("gauge"))
    r, a = TF.fused_temporal(v, 5, STEP, ("rate", "avg_over_time"))
    assert torch.equal(r.nan_to_num(), TF.FUSABLE["rate"](v, 5, STEP).nan_to_num())
    assert torch.equal(a.nan_to_num(), TF.FUSABLE["avg_over_time"](v, 5, STEP).nan_to_num())
    assert torch.equal(TF.temporal_apply("max_over_time", v, 5, STEP).nan_to_num(),
                       TF.FUSABLE["max_over_time"](v, 5, STEP).nan_to_num())


def test_fused_temporal_rejects_bad_arguments():
    v = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        TF.fused_temporal(v, 3, STEP, ("deriv",))
    with pytest.raises(ValueError):
        TF.fused_temporal(v, 0, STEP, ("rate",))
    with pytest.raises(ValueError):
        TF.fused_temporal(v[0], 3, STEP, ("rate",))


@pytest.fixture(scope="module")
def host_b2():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tempfile.mkdtemp(prefix="b2_host_") + "/temporal_fused_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, str(_build.SOURCES["temporal_fused"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    fn = lib.m3_temporal_fused_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    fn.groups = lib.m3_temporal_fused_groups
    fn.groups.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.groups.restype = ctypes.c_int
    return fn


def _host_run(host_b2, v, window, names):
    outs = [np.zeros_like(v) for _ in names]
    ptrs = (ctypes.c_void_p * len(names))(*[o.ctypes.data for o in outs])
    ids = (ctypes.c_int * len(names))(*[list(TF.FUSABLE).index(n) for n in names])
    assert host_b2(v.ctypes.data, v.shape[0], v.shape[1], window, STEP, ptrs, ids, len(names)) == 0
    return outs, host_b2.groups(ids, len(names))


def _assert_host_matches(names, outs, v, window):
    twin = TF.fused_temporal(torch.from_numpy(v), window, STEP, tuple(names))
    for name, got, want in zip(names, outs, twin):
        want = want.numpy()
        if name.startswith("std"):  # the row's nanmean is summed in another order
            _assert_close(got, want, 5e-3, 1e-4, f"{name} w={window}")
            continue
        same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
        assert same.all(), f"{name} w={window}: {(~same).sum()} values differ from the twin"


# windows 1/5/7/200, and 150 > T = 120; 95 rows, not a multiple of the
# kernel's 8 rows (one a warp) per CTA
SPEC_WINDOWS = WINDOWS + [150]
ALL_GROUPS = 511


@pytest.mark.parametrize("name", list(TF.FUSABLE))
def test_host_build_single_function_specialisation(host_b2, name):
    kinds = ("gauge",) if name.startswith("std") else ("gauge", "counter")
    for kind in kinds:
        v = np.ascontiguousarray(_data(kind)[:95])
        for window in SPEC_WINDOWS:
            outs, groups = _host_run(host_b2, v, window, [name])
            assert groups != ALL_GROUPS, f"{name} ran the all-function kernel"
            _assert_host_matches([name], outs, v, window)


@pytest.mark.parametrize("names", [tuple(TF.FUSABLE), ("rate", "max_over_time", "resets")],
                         ids=["all15", "mixed3"])
def test_host_build_multi_function_kernel(host_b2, names):
    v = np.ascontiguousarray(_data("gauge")[:95])
    for window in SPEC_WINDOWS:
        outs, groups = _host_run(host_b2, v, window, list(names))
        assert groups == ALL_GROUPS
        _assert_host_matches(names, outs, v, window)


def _wide_counters():
    """Counter rows whose scale runs from 1e-40 (subnormal) to 1e36, with
    resets to near zero: the zero-point clamp applies often, and the
    extrapolation table's fast path must hand every column whose operands
    leave the normal f32 range to the exact formula. The first 12 rows
    never reset."""
    rng = np.random.default_rng(11)
    v = np.cumsum(rng.exponential(5.0, (48, 120)), axis=1)
    reset = rng.random(v.shape) < 0.05
    reset[:12] = False
    v = v - np.maximum.accumulate(np.where(reset, v, 0.0), axis=1) + reset * rng.random(v.shape)
    v = v * 10.0 ** rng.uniform(-40, 36, (48, 1))
    v = v.astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.nan
    return np.ascontiguousarray(v)


@pytest.mark.parametrize("step", [STEP, 0.1])
@pytest.mark.parametrize("name", ["rate", "increase", "delta"])
def test_host_build_rate_family_wide_magnitudes(host_b2, name, step):
    """rate / increase / delta bit for bit on counters of every magnitude, at
    a step whose window products are exact (10 s) and one whose are not
    (0.1 s, where duration_to_start is not 0 on full windows)."""
    v = _wide_counters()
    for window in (2, 7, 16, 17, 61):
        outs = [np.zeros_like(v)]
        ids = (ctypes.c_int * 1)(list(TF.FUSABLE).index(name))
        ptrs = (ctypes.c_void_p * 1)(outs[0].ctypes.data)
        assert host_b2(v.ctypes.data, v.shape[0], v.shape[1], window, step, ptrs, ids, 1) == 0
        want = TF.FUSABLE[name](torch.from_numpy(v), window, step).numpy()
        got = outs[0]
        same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
        assert same.all(), f"{name} w={window} step={step}: {(~same).sum()} values differ"


@pytest.mark.parametrize("kind", ["gauge", "counter"])
@pytest.mark.parametrize("window", WINDOWS)
def test_kernel_source_host_build_matches_twin(host_b2, kind, window):
    v = np.ascontiguousarray(_data(kind))
    names = [n for n in TF.FUSABLE if kind == "gauge" or not n.startswith("std")]
    outs = [np.zeros_like(v) for _ in names]
    ptrs = (ctypes.c_void_p * len(names))(*[o.ctypes.data for o in outs])
    ids = (ctypes.c_int * len(names))(*[list(TF.FUSABLE).index(n) for n in names])
    assert host_b2(v.ctypes.data, v.shape[0], v.shape[1], window, STEP, ptrs, ids, len(names)) == 0
    twin = TF.fused_temporal(torch.from_numpy(v), window, STEP, tuple(names))
    for name, got, want in zip(names, outs, twin):
        atol = 5e-3 if name.startswith("std") else 1e-4
        _assert_close(got, want.numpy(), atol, 1e-4, f"{name} w={window}")


# ---------------------------------------------------------------------------
# kernel B-7: deriv, predict_linear, holt_winters, quantile_over_time
# ---------------------------------------------------------------------------

B7_WINDOWS = [1, 5, 16, 61]
B7_QS = [-0.5, 0.0, 0.5, 0.9, 1.0, 1.5]
B7_CALLS = ([("deriv", ()), ("predict_linear", (600.0,)), ("predict_linear", (-45.0,)),
             ("holt_winters", (0.3, 0.6)), ("holt_winters", (0.9, 0.1))]
            + [("quantile_over_time", (q,)) for q in B7_QS])


def _b7_data():
    """tests/test_temporal.py's data: 7 x 60, 25% NaN, an empty row (2), a
    strided row (3), a counter-like row (0)."""
    rng = np.random.default_rng(42)
    vals = np.cumsum(rng.normal(1.0, 5.0, (7, 60)), axis=1).astype(np.float32)
    vals[0] = np.abs(vals[0])
    vals[rng.random(vals.shape) < 0.25] = np.nan
    vals[2, :] = np.nan
    vals[3, ::2] = np.nan
    return np.ascontiguousarray(vals)


def _b7_specials():
    """Rows of infinities, signed zeros and repeated values, with NaN."""
    rng = np.random.default_rng(19)
    pool = np.asarray([np.inf, -np.inf, 0.0, -0.0, 1.5, 1.5, -2.0, 3e38, -3e38, 1e-40, np.nan],
                      np.float32)
    v = pool[rng.integers(0, len(pool), (9, 53))]
    v[0] = np.where(np.arange(53) % 2, 0.0, -0.0)
    v[1, :30] = np.nan
    return np.ascontiguousarray(v.astype(np.float32))


def _jax_b7(name, v, w, args, chunk):
    x = jnp.asarray(v)
    if name == "deriv":
        return jt.deriv(x, w, STEP)
    if name == "predict_linear":
        return jt.predict_linear(x, w, STEP, *args)
    if name == "holt_winters":
        return jt.holt_winters(x, w, *args, chunk=chunk)
    return jt.quantile_over_time(x, w, *args, chunk=chunk)


def _twin_b7(name, v, w, args, chunk):
    x = torch.from_numpy(v)
    if name == "deriv":
        return TW.T.deriv(x, w, STEP, chunk)
    if name == "predict_linear":
        return TW.T.predict_linear(x, w, STEP, *args, chunk)
    if name == "holt_winters":
        return TW.T.holt_winters(x, w, *args, chunk)
    return TW.T.quantile_over_time(x, w, *args, chunk)


def _assert_close_inf(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf]), f"{what}: infinities differ"
    _assert_close(np.where(inf, 0, got), np.where(inf, 0, want), 1e-4, 1e-4, what)


@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("w", B7_WINDOWS)
@pytest.mark.parametrize("name,args", B7_CALLS)
def test_b7_twin_matches_jnp(name, args, w, chunk):
    v = _b7_data()
    want = _jax_b7(name, v, w, args, chunk)
    got = _twin_b7(name, v, w, args, chunk)
    assert got.dtype == torch.float32 and got.shape == v.shape
    _assert_close_inf(got.numpy(), want, f"{name}{args} w={w} chunk={chunk}")
    # no output depends on the chunk
    other = _twin_b7(name, v, w, args, 7)
    assert _bits_equal(other.numpy(), got.numpy())


def test_b7_wrapper_on_the_cpu_runs_the_twin():
    v = torch.from_numpy(_b7_data())
    assert torch.equal(TW.temporal_window("deriv", v.double(), 5, STEP).nan_to_num(),
                       TW.T.deriv(v, 5, STEP).nan_to_num())
    got = TW.temporal_window("holt_winters", v, 5, STEP, 0.3, 0.6)
    assert torch.equal(got.nan_to_num(), TW.T.holt_winters(v, 5, 0.3, 0.6).nan_to_num())
    for bad in [("rate", v, 5, STEP), ("deriv", v, 0, STEP), ("deriv", v[0], 5, STEP),
                ("holt_winters", v, 5, STEP, 0.3), ("quantile_over_time", v, 5, STEP)]:
        with pytest.raises(ValueError):
            TW.temporal_window(*bad)


@pytest.fixture(scope="module")
def host_b7_lib():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tempfile.mkdtemp(prefix="b7_host_") + "/temporal_window_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, str(_build.SOURCES["temporal_window"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    # rows, cols, window, first, fn, run, force_global, out int64[9]
    lib.m3_temporal_window_shape.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.m3_temporal_window_shape.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def host_b7(host_b7_lib):
    fn = host_b7_lib.m3_temporal_window_host
    F = ctypes.c_float
    # x, rows, cols, window, first, fn, a, b, c, d, run, force_global, out
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, F, F, F, F, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bits_equal(got, want):
    return ((got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))).all()


@pytest.mark.parametrize("data", ["temporal", "specials"])
@pytest.mark.parametrize("w", B7_WINDOWS + [3, 200])
@pytest.mark.parametrize("name,args", B7_CALLS)
def test_b7_host_build_matches_twin(host_b7, name, args, w, data):
    v = _b7_data() if data == "temporal" else _b7_specials()
    want = _twin_b7(name, v, w, args, 128).numpy()
    params = TW._params(name, STEP, args)
    runs = (0, 1, 3, 100) if name == "quantile_over_time" else (0,)
    for force_global in (0, 1):
        for run in runs:
            out = np.zeros_like(v)
            assert host_b7(v.ctypes.data, v.shape[0], v.shape[1], w, 0, TW._FN_ID[name], *params,
                           run, force_global, out.ctypes.data) == 0
            assert _bits_equal(out, want), (
                f"{name}{args} w={w} run={run} global={force_global}: differs from the twin")


@pytest.mark.parametrize("w", [1, 2, 3, 31, 61, 200])
@pytest.mark.parametrize("name,args", B7_CALLS)
def test_b7_host_build_matches_twin_on_validity_patterns(host_b7, name, args, w):
    """The staged route's paths (fold tables for windows whose samples are
    their last ones, the flag fold for any other window, the
    interleaved holt_winters recurrences, the quantile's one-shift slide,
    NaN without a walk) and the device-memory route, each == the twin
    sliced at first, bit for bit."""
    names, v = b7_patterns(w)
    cols = v.shape[1]
    want = _twin_b7(name, v, w, args, 128).numpy()
    params = TW._params(name, STEP, args)
    runs = (0, 1, 7) if name == "quantile_over_time" else (0,)
    for first in sorted({0, min(w - 1, cols), cols - 1}):
        for force_global in (0, 1):
            for run in runs:
                out = np.zeros((v.shape[0], cols - first), np.float32)
                assert host_b7(v.ctypes.data, v.shape[0], cols, w, first, TW._FN_ID[name],
                               *params, run, force_global, out.ctypes.data) == 0
                for i, row in enumerate(names):
                    assert _bits_equal(out[i], want[i, first:]), (
                        f"{name}{args} w={w} first={first} run={run} global={force_global}: "
                        f"{row} differs from the twin")


@pytest.mark.parametrize("name,args", B7_CALLS[:4] + [("quantile_over_time", (0.9,))])
def test_b7_host_build_long_window(host_b7, name, args):
    """A window longer than the fold tables' (W = 1,100 > 1,024: every
    linear window folds sum d and sum d^2 with the flags) and than the
    register sort's (the quantile's first windows by insertion), staged."""
    rng = np.random.default_rng(37)
    v = np.cumsum(rng.normal(0.5, 3.0, (3, 1300)), axis=1).astype(np.float32)
    v[1, :1150] = np.nan
    v[2, rng.random(1300) < 0.1] = np.nan
    want = _twin_b7(name, v, 1100, args, 128).numpy()
    params = TW._params(name, STEP, args)
    for first in (0, 1099):
        out = np.zeros((3, 1300 - first), np.float32)
        assert host_b7(v.ctypes.data, 3, 1300, 1100, first, TW._FN_ID[name], *params, 0, 0,
                       out.ctypes.data) == 0
        assert _bits_equal(out, want[:, first:]), f"{name}{args} first={first}"


@pytest.mark.parametrize("cols,w", [(750, 31), (1080, 361), (961, 120), (1080, 200),
                                    (60, 5), (1300, 1100), (5000, 361), (4000, 2000)])
def test_b7_quantile_layout_keeps_runs_of_half_a_window(host_b7_lib, cols, w):
    """The staged quantile's layout at the engine's first = W - 1: runs of
    at least W/2 columns (the whole row where it is shorter), as many runs
    as a power of two allows, at most 32 lanes a warp, and rows a warp
    dropped (idle lanes) rather than runs shortened where shared memory
    holds fewer rows: so [promql]'s W = 31 keeps 32 lanes of 23 columns and
    W = 361 over 720 columns two lanes of 360."""
    out = np.zeros(9, np.int64)
    first = w - 1
    n_out = cols - first
    assert host_b7_lib.m3_temporal_window_shape(100_000, cols, w, first, TW._FN_ID[
        "quantile_over_time"], 0, 0, out.ctypes.data) == 0
    shape = dict(zip(("threads", "run", "staged", "smem_bytes", "blocks", "scratch_bytes",
                      "rows_per_warp", "lanes_per_row", "tables"), (int(x) for x in out)))
    lanes, rows, run = shape["lanes_per_row"], shape["rows_per_warp"], shape["run"]
    assert shape["staged"] == 1
    assert run >= min(n_out, (w + 1) // 2), shape
    assert lanes * run >= n_out, shape
    assert lanes & (lanes - 1) == 0 and lanes * rows <= 32, shape
    assert lanes == 32 or 2 * lanes * (w + 1) > n_out, shape  # no more runs fit
    # each warp: its rows' slots and windows, in kQuantWarpBytes unless one row overflows it
    warp = rows * (-(-(n_out + w - 1) // 4) * 4 + lanes * w) * 4
    assert shape["smem_bytes"] == shape["threads"] // 32 * warp, shape
    assert rows == 1 or warp <= 16384, shape
    assert rows * 2 * lanes > 32 or 2 * warp > 16384, shape  # no more rows fit
    if (cols, w) == (750, 31):
        assert (lanes, rows, run) == (32, 1, 23)
    if (cols, w) == (1080, 361):
        assert (lanes, rows, run) == (2, 2, 360)


@pytest.mark.parametrize("name,args", B7_CALLS[:4] + [("quantile_over_time", (0.9,))])
def test_b7_wrapper_first_slices_the_twin(name, args):
    v = torch.from_numpy(_b7_data())
    full = TW.temporal_window(name, v, 16, STEP, *args)
    assert full.shape == v.shape
    for first in (0, 1, 15, 59, 60):
        got = TW.temporal_window(name, v, 16, STEP, *args, first=first)
        assert got.shape == (v.shape[0], v.shape[1] - first)
        assert _bits_equal(got.numpy(), full[:, first:].numpy())
    for bad in (-1, 61):
        with pytest.raises(ValueError):
            TW.temporal_window(name, v, 16, STEP, *args, first=bad)


def _b7_engine_series():
    """Gauges that start late, stop early, have a gap, and a full one, 120
    points at 10 s."""
    from m3_tpu_torch.block.core import make_tags

    from test_torch_promql import STEP as QSTEP
    from test_torch_promql import T0

    rng = np.random.default_rng(31)
    out = []
    for i, (lo, hi, gap) in enumerate([(0, 120, None), (45, 120, None), (0, 70, None),
                                       (0, 120, (30, 52)), (90, 120, (100, 104))]):
        keep = np.zeros(120, bool)
        keep[lo:hi] = True
        if gap:
            keep[gap[0]:gap[1]] = False
        ts = T0 + QSTEP * np.flatnonzero(keep).astype(np.int64)
        vs = np.cumsum(rng.normal(0.5, 3.0, 120))[keep]
        out.append((make_tags({"__name__": "g", "host": f"h{i}"}), ts, vs))
    return out


@pytest.mark.parametrize("query", [
    "predict_linear(g[5m], 600)", "deriv(g[2m])", "holt_winters(g[3m], 0.3, 0.6)",
    "quantile_over_time(0.9, g[3m])", "quantile_over_time(0.25, g[30s])",
    "predict_linear(g[30m], 3600) < 0",
])
def test_b7_engine_matches_jax_engine(query):
    """The engine's B-7 call (first = W - 1) against the JAX Engine."""
    from m3_tpu.query import engine as jengine

    from test_torch_promql import T0, _assert_results, _both, _RawStorage
    from test_torch_promql import STEP as QSTEP

    raw = _RawStorage(_b7_engine_series())
    got, want = _both((raw, raw), query, T0 + 20 * QSTEP, T0 + 119 * QSTEP, QSTEP,
                      jengine.DEFAULT_LOOKBACK)
    _assert_results(got, want, query)
