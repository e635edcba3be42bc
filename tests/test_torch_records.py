"""Port parity for the records decode (m3_tpu_torch.ops.chunked, kernel R).

- ``decode_chunked`` (its plain PyTorch twin, on the CPU) equals m3_tpu's
  ``decode_chunked`` field by field and exactly: timestamps, value bits,
  point_is_float, mult, valid and err.
- ``finalize_decode`` equals the JAX package's ``finalize_decode`` bit for
  bit in float64.
- Kernel R's source, compiled as host C++, equals the twin on every record.
The kernel itself is held to the twin on a card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from m3_tpu.ops import chunked as jchunked
from m3_tpu.ops import decode as jdecode
from m3_tpu.utils import synthetic as jsyn
from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import decode as tdecode
from m3_tpu_torch.ops import fused as tfused

N_SERIES, N_POINTS, K = 96, 120, 24
KINDS = ["gauge", "counter", "float", "mixed"]


def _streams(kind):
    if kind == "mixed":
        # floats, counters, time-unit changes and annotations (err series)
        return jsyn.synthetic_mixed_streams(N_SERIES, N_POINTS, seed=31, frac_float=0.3,
                                            frac_tu_change=0.1, frac_annotation=0.1)
    return jsyn.synthetic_streams(N_SERIES, N_POINTS, seed=13, kind=kind)


_cache = {}


def _decoded(kind):
    """(JAX DecodeResult, port DecodeResult, port packed lanes)."""
    if kind not in _cache:
        streams = _streams(kind)
        want = jchunked.decode_chunked(jchunked.build_chunked(streams, k=K))
        tb = tchunked.build_chunked(streams, k=K)
        p = tfused.pack_lanes(tb, order="s", rows=8, device="cpu")
        got = tchunked.decode_chunked(p.windows, p.lanes, tb.num_series, tb.num_chunks, K)
        _cache[kind] = (want, got, p)
    return _cache[kind]


def _i64(hi, lo):
    return ((np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)).view(np.int64)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_chunked_matches_jax(kind):
    want, got, _ = _decoded(kind)
    np.testing.assert_array_equal(got.ts.numpy(), _i64(want.ts_hi, want.ts_lo))
    np.testing.assert_array_equal(got.bits.numpy(), _i64(want.val_hi, want.val_lo))
    np.testing.assert_array_equal(got.point_is_float.numpy(), np.asarray(want.point_is_float))
    np.testing.assert_array_equal(got.mult.numpy(), np.asarray(want.mult))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.err.numpy(), np.asarray(want.err))
    assert got.ts.shape == (N_SERIES, -(-N_POINTS // K) * K)
    assert int(got.valid.sum()) > 0
    if kind == "mixed":
        assert got.err.any() and got.point_is_float.any()


@pytest.mark.parametrize("kind", KINDS)
def test_finalize_decode_bit_identical(kind):
    want, got, _ = _decoded(kind)
    t_want, v_want, ok_want = jdecode.finalize_decode(want)
    t_got, v_got, ok_got = tdecode.finalize_decode(got)
    assert v_got.dtype == torch.float64
    np.testing.assert_array_equal(t_got.numpy(), t_want)
    np.testing.assert_array_equal(ok_got.numpy(), ok_want)
    np.testing.assert_array_equal(v_got.numpy().view(np.int64), v_want.view(np.int64))


def test_finalize_values_every_mult():
    """Int points at every mult 0..6, big and negative ints, float bits."""
    rng = np.random.default_rng(4)
    n = 7000
    ints = np.concatenate([rng.integers(-2**62, 2**62, n // 2), rng.integers(-10**7, 10**7, n - n // 2)])
    mult = np.arange(n) % 7
    pif = rng.random(n) < 0.3
    bits = np.where(pif, rng.normal(0, 1e3, n).view(np.int64), ints)
    raw = bits.view(np.uint64)
    res = jdecode.DecodeResult(
        ts_hi=np.zeros(n, np.uint32), ts_lo=np.zeros(n, np.uint32),
        val_hi=(raw >> np.uint64(32)).astype(np.uint32), val_lo=(raw & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        point_is_float=pif, mult=mult.astype(np.int32), valid=np.ones(n, bool),
        err=np.zeros(1, bool), values_f32=np.zeros(n, np.float32),
    )
    _, want, _ = jdecode.finalize_decode(res)
    got = tdecode.finalize_values(torch.from_numpy(bits), torch.from_numpy(pif),
                                  torch.from_numpy(mult.astype(np.uint8)))
    np.testing.assert_array_equal(got.numpy().view(np.int64), want.view(np.int64))


@pytest.fixture(scope="module")
def host_records():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    import tempfile

    out = tempfile.mkdtemp(prefix="records_host_") + "/lane_aggregates_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, str(_build.SOURCES["lane_aggregates"][0])],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(out).m3_decode_records_host
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_r_source_host_build_matches_twin(host_records, kind):
    _, _, p = _decoded(kind)
    cw, npad = p.windows.shape
    n = p.n
    ts = np.zeros((n, K), np.int64)
    bits = np.zeros((n, K), np.int64)
    small = np.zeros((3, n, K), np.uint8)
    err = np.zeros(n, np.uint8)
    win, lanes = p.windows.numpy(), p.lanes.numpy()
    rc = host_records(win.ctypes.data, lanes.ctypes.data, npad, n, cw, tdecode.barrel_mask(cw), K,
                      ts.ctypes.data, bits.ctypes.data, small[0].ctypes.data,
                      small[1].ctypes.data, small[2].ctypes.data, err.ctypes.data)
    assert rc == 0
    want = tchunked.decode_chunked_lanes(p.windows, p.lanes, n=n, k=K)
    np.testing.assert_array_equal(ts, want.ts.numpy())
    np.testing.assert_array_equal(bits, want.bits.numpy())
    np.testing.assert_array_equal(small[0] != 0, want.point_is_float.numpy())
    np.testing.assert_array_equal(small[1], want.mult.numpy())
    np.testing.assert_array_equal(small[2] != 0, want.valid.numpy())
    np.testing.assert_array_equal(err != 0, want.err.numpy())


def test_decode_chunked_lanes_rejects_bad_inputs():
    p = tfused.pack_lanes(tchunked.build_chunked(jsyn.synthetic_streams(2, 30, seed=1), k=16),
                          order="s", device="cpu")
    with pytest.raises(TypeError):
        tchunked.decode_chunked_lanes(p.windows.long(), p.lanes, n=p.n, k=16)
    with pytest.raises(ValueError):
        tchunked.decode_chunked_lanes(p.windows, p.lanes[:5], n=p.n, k=16)
    with pytest.raises(ValueError):
        tchunked.decode_chunked_lanes(p.windows, p.lanes, n=p.n, k=0)
