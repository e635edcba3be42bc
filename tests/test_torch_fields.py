"""Port parity for kernel B3, the per-field lane-aggregate kernel
(m3_tpu_torch.ops.fused.lane_aggregates_fields), and the scan over it.

- The plain PyTorch twin equals m3_tpu's Pallas kernel
  ``lane_aggregates_pallas`` (run in interpret mode, as tests/test_fused.py
  runs it on the CPU) PER LANE: count and err exact, sum/min/max/last
  bit-identical with NaN in the same places.
- B3's CUDA source, compiled as host C++, equals the twin per lane, also
  on a ragged lane count and on 32-lane groups that are all int, all float
  or mixed (the walk's per-warp decisions, taken by the host build per
  group), with time-unit changes, annotations, EOS mid-chunk, mult up to 6
  and values scaled to 1e-40.
- ``chunked_scan_aggregate_fused`` equals the JAX package's
  ``chunked_scan_aggregate_fused(backend="jnp")``: counts, min, max, last
  and err exact; sums within rtol 1e-6, because torch and XLA add a
  series' chunk sums in different orders (the lanes are bit-identical).
The kernel itself is held to the twin on a card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from m3_tpu.codec.m3tsz import Encoder
from m3_tpu.ops import chunked as jchunked
from m3_tpu.ops import fused as jfused
from m3_tpu.parallel import scan as jscan
from m3_tpu.utils import synthetic as jsyn
from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import decode as tdecode
from m3_tpu_torch.ops import fused as tfused
from m3_tpu_torch.parallel import scan as tscan
from torch_streams import group_streams

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 5e-324, 1e-40, -1e-42,
            1e300, -1e300, 3.4e38, 1e-39, -3.0, -1.0, -2.5, 7.0]


def _encode_values(rows):
    out = []
    for vals in rows:
        enc = Encoder(T0)
        for j, v in enumerate(vals):
            enc.encode(T0 + j * NANOS, float(v))
        out.append(enc.stream())
    return out


# name -> (streams factory, k)
CASES = {
    "gauge": (lambda: jsyn.synthetic_streams(32, 97, seed=13, kind="gauge"), 16),
    "float": (lambda: jsyn.synthetic_streams(24, 97, seed=13, kind="float"), 24),
    "mixed": (lambda: jsyn.synthetic_mixed_streams(96, 97, seed=5, frac_float=0.5), 16),
    # time-unit changes and annotations: annotated lanes set err
    "annotated": (lambda: jsyn.synthetic_mixed_streams(
        32, 97, seed=31, frac_tu_change=0.2, frac_annotation=0.2), 16),
    # small negative ints: the general body's u64.to_f32 maps -3 to 0.0, and
    # B3 runs the general body on every lane
    "negative_int": (lambda: _encode_values(
        [[-3.0] * 97, [-1.0, -2.0, 0.0, -7.0] * 24 + [-5.0]]), 24),
    # 32-lane groups all int / all float / mixed, 672 lanes (not a multiple
    # of 128); see tests/torch_streams.group_streams
    "groups": (group_streams, 16),
    # time-unit markers (19 + 64-bit timestamps) in half the series
    "tu_change": (lambda: jsyn.synthetic_mixed_streams(
        32, 97, seed=11, frac_float=0.3, frac_tu_change=0.5, frac_annotation=0.0), 16),
    # NaN, infinities, signed zeros, f64 and f32 subnormals, f32 overflow
    "specials": (lambda: _encode_values(
        [[0.5] + [SPECIALS[(j * 7 + s) % len(SPECIALS)] for j in range(96)] for s in range(16)]),
        16),
}

_cache = {}


def _inputs(name):
    """(JAX ChunkedBatch, port per-field args on cpu, k)."""
    if name not in _cache:
        make, k = CASES[name]
        streams = make()
        jb = jchunked.build_chunked(streams, k=k)
        args = tscan.chunked_device_args(tchunked.build_chunked(streams, k=k), device="cpu")
        _cache[name] = (jb, args, k)
    return _cache[name]


def _assert_lanes_identical(got, want):
    np.testing.assert_array_equal(np.asarray(got.count), np.asarray(want.count))
    np.testing.assert_array_equal(np.asarray(got.err), np.asarray(want.err))
    for f in ("sum", "min", "max", "last"):
        g = np.asarray(getattr(got, f), np.float32)
        w = np.asarray(getattr(want, f), np.float32)
        same = (g.view(np.int32) == w.view(np.int32)) | (np.isnan(g) & np.isnan(w))
        bad = np.nonzero(~same)[0]
        assert bad.size == 0, f"{f} differs at lanes {bad[:5]}: {g[bad[:5]]} vs {w[bad[:5]]}"


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_pallas_kernel_per_lane(name):
    jb, args, k = _inputs(name)
    want = jfused.lane_aggregates_pallas(**jchunked.lane_kwargs(jb), k=k, interpret=True)
    got = tfused.lane_aggregates_fields(**args, k=k)
    _assert_lanes_identical(got, want)
    if name == "annotated":
        assert np.asarray(want.err).any()
    if name == "negative_int":
        # lane 0 holds the first 24 records of the all -3 series
        assert float(want.min[0]) == 0.0 and int(want.count[0]) == 24
    if name == "specials":
        assert np.isnan(np.asarray(want.sum)).any() and np.isinf(np.asarray(want.max)).any()


def test_fields_twin_equals_packed_twin_on_general_tiles():
    """B3 and B1's general body are one walk: on series-major packed lanes
    with every tile forced general, B1's twin gives B3's per-lane values."""
    jb, args, k = _inputs("mixed")
    batch = tchunked.build_chunked(CASES["mixed"][0](), k=k)
    p = tfused.pack_lanes(batch, order="s", rows=8, device="cpu")
    b1 = tfused.lane_aggregates_reference(p.windows, p.lanes, torch.zeros_like(p.tile_flags),
                                          n=p.n, k=k)
    _assert_lanes_identical(tfused.lane_aggregates_fields(**args, k=k), b1)


def test_fields_rejects_bad_inputs():
    _, args, k = _inputs("gauge")
    bad = dict(args, windows=args["windows"].to(torch.int64))
    with pytest.raises(TypeError):
        tfused.lane_aggregates_fields(**bad, k=k)
    bad = dict(args, first=args["first"].to(torch.int32))
    with pytest.raises(TypeError):
        tfused.lane_aggregates_fields(**bad, k=k)
    bad = dict(args, sig=args["sig"][:-1])
    with pytest.raises(TypeError):
        tfused.lane_aggregates_fields(**bad, k=k)
    with pytest.raises(ValueError):
        tfused.lane_aggregates_fields(**args, k=0)


def test_chunked_device_args_layout():
    jb, args, _ = _inputs("mixed")
    n, cw = jb.windows.shape
    assert args["windows"].dtype == torch.int32 and tuple(args["windows"].shape) == (n, cw)
    np.testing.assert_array_equal(args["windows"].numpy().view(np.uint32), jb.windows)
    assert args["first"].dtype == torch.bool and args["is_float"].dtype == torch.bool
    hi, lo = args["prev_time"]
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), jb.prev_time[0])
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), jb.prev_time[1])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["gauge", "mixed", "annotated"])
def test_fused_scan_matches_jax(name):
    jb, args, k = _inputs(name)
    s, c = jb.num_series, jb.num_chunks
    want = jscan.chunked_scan_aggregate_fused(jchunked.lane_kwargs(jb), s, c, k, backend="jnp")
    got = tscan.chunked_scan_aggregate_fused(args, s, c, k)
    for f in ("series_count", "series_min", "series_max", "series_last", "series_err"):
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(_np(got.series_sum), np.asarray(want.series_sum), rtol=1e-6)
    assert int(got.total_count) == int(want.total_count)
    for f in ("total_min", "total_max"):
        assert float(getattr(got, f)) == float(getattr(want, f)), f
    np.testing.assert_allclose(float(got.total_sum), float(want.total_sum), rtol=1e-6)


# ---------------------------------------------------------------------------
# B3's CUDA source, compiled for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "lane_aggregates_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["lane_aggregates"][0])],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(str(out)).m3_lane_aggregates_fields_host
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_source_host_build_matches_twin(host_kernel, name):
    _, args, k = _inputs(name)
    windows = args["windows"]
    planes = tfused._field_planes(windows, {f: v for f, v in args.items() if f != "windows"}, k)
    n, cw = windows.shape
    out_f = np.zeros((4, n), np.float32)
    out_cnt = np.zeros(n, np.int32)
    out_err = np.zeros(n, np.uint8)
    fields = (ctypes.c_void_p * tfused.NLANE)(*[p.data_ptr() for p in planes])
    rc = host_kernel(windows.data_ptr(), fields, n, cw, tdecode.barrel_mask(cw), k,
                     out_f.ctypes.data, out_cnt.ctypes.data, out_err.ctypes.data)
    assert rc == 0
    got = tfused.LaneAggregates(sum=out_f[0], count=out_cnt, min=out_f[1], max=out_f[2],
                                last=out_f[3], err=out_err != 0)
    _assert_lanes_identical(got, tfused.lane_aggregates_fields(**args, k=k))
