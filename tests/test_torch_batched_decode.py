"""Port parity for the whole-stream decode (m3_tpu_torch.ops.decode
decode_batched, kernel B-6) and its container (m3_tpu_torch.segment.batched).

- Every case of tests/test_batched_decode.py, and cases of mixed synthetic
  streams, of ``max_points`` past a stream's records and of word rows at and
  below their minimum width (the fetch's clamp to W - 1), go through
  ``m3_tpu.ops.decode.decode_batched`` (XLA on the CPU) and the port's twin
  (``decode_batched(..., device="cpu")``): timestamps, value bits,
  point_is_float, mult, valid, err and values_f32 equal bit for bit (NaNs by
  their bits), in both ``int_optimized`` modes where the case has both.
- The port's decode equals the port's host codec on the cases whose
  reference test does (bit-exact f64 values through ``finalize_decode``).
- Kernel B-6's source, compiled as host C++, equals the twin on every case.
- ``BatchedSegments`` words, ``initial_units`` and ``tiled_batch`` equal
  ``m3_tpu``'s.
The kernel itself is held to the twin on a card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import ctypes
import math
import random
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

from m3_tpu.codec import m3tsz as jm
from m3_tpu.ops import decode as jdecode
from m3_tpu.segment.batched import BatchedSegments as JBatched
from m3_tpu.utils import synthetic as jsyn
from m3_tpu.utils.xtime import Unit as JUnit
from m3_tpu_torch.codec import m3tsz as tm
from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops import decode as tdecode
from m3_tpu_torch.segment.batched import BatchedSegments as TBatched
from m3_tpu_torch.utils import synthetic as tsyn
from m3_tpu_torch.utils.xtime import Unit

START = 1_600_000_000 * 10**9


def _mixed_random():
    random.seed(1)
    streams = []
    for _ in range(40):
        n = random.randrange(1, 50)
        t = START + random.randrange(0, 100) * 10**9
        ts, vals = [], []
        for _ in range(n):
            t += random.choice([9, 10, 10, 10, 11, 30]) * 10**9
            ts.append(t)
            kind = random.random()
            if kind < 0.5:
                vals.append(float(random.randrange(-(10**6), 10**6)))
            elif kind < 0.8:
                vals.append(round(random.uniform(-1000, 1000), random.randrange(0, 5)))
            else:
                vals.append(random.uniform(-1e9, 1e9))
        streams.append(jm.encode_series(ts, vals, start_nanos=START))
    return streams


def _time_unit_change():
    enc = jm.Encoder(START)
    enc.encode(START + 10**9, 1.0, unit=JUnit.SECOND)
    enc.encode(START + 10**9 + 250_000_000, 2.5, unit=JUnit.MILLISECOND)
    enc.encode(START + 10**9 + 500_000_000, 3.0, unit=JUnit.MILLISECOND)
    enc.encode(START + 3 * 10**9, 4.0, unit=JUnit.SECOND)
    return [enc.stream()]


def _unaligned_start_marker():
    start = START + 123
    enc = jm.Encoder(start)
    enc.encode(start + 10**9, 7.0)
    enc.encode(start + 2 * 10**9, 8.0)
    return [enc.stream()]


def _ns_bucket():
    enc = jm.Encoder(START, default_unit=JUnit.NANOSECOND)
    ts = [START + 1, START + 2, START + 3 + 10**15, START + 4 + 10**15]
    for t, v in zip(ts, [1.0, 2.0, 3.0, 4.5]):
        enc.encode(t, v, unit=JUnit.NANOSECOND)
    return [enc.stream()]


def _special_floats(int_optimized):
    vals = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1e-300, 1e300, math.pi]
    ts = [START + (i + 1) * 10**9 for i in range(len(vals))]
    return [jm.encode_series(ts, vals, start_nanos=START, int_optimized=int_optimized)]


def _repeats_and_mode_flips():
    random.seed(9)
    vals = ([5.0] * 10 + [5.5, 6.5, math.e, 7.0]
            + [1000000.0 + random.choice([1, -1]) for _ in range(20)] + [42.0] * 5)
    ts = [START + (i + 1) * 10 * 10**9 for i in range(len(vals))]
    return [jm.encode_series(ts, vals, start_nanos=START)]


def _ragged_with_empty():
    s0 = jm.encode_series([START + 10**9], [1.5], start_nanos=START)
    s2 = jm.encode_series([START + i * 10**9 for i in range(1, 100)],
                          [float(i) for i in range(99)], start_nanos=START)
    return [s0, b"", s2]


def _annotation():
    enc = jm.Encoder(START)
    enc.encode(START + 10**9, 1.0, annotation=b"x")
    return [enc.stream()]


def _sine():
    ts = [START + (i + 1) * 10**9 for i in range(20)]
    return [jm.encode_series(ts, [math.sin(i / 3.0) * 100 for i in range(20)], start_nanos=START)]


def _float_random():
    rng = np.random.default_rng(8)
    ts = [START + (i + 1) * 10**9 for i in range(40)]
    return [jm.encode_series(ts, list(rng.normal(0, 10 ** (i % 5), 40)), start_nanos=START,
                             int_optimized=False) for i in range(12)]


def _synthetic_mixed():
    # floats, counters, time-unit changes and annotations (err series)
    return jsyn.synthetic_mixed_streams(64, 60, seed=31, frac_float=0.3, frac_tu_change=0.1,
                                        frac_annotation=0.1)


def _long_annotation():
    # a 300-byte annotation (2,400 bits: longer than a ring of 32 words)
    # after 5 points ends that series with err, as the reference's decode
    # does; the other series of its warp decode on
    enc = jm.Encoder(START)
    for i in range(40):
        note = bytes(range(256)) + b"x" * 44 if i == 5 else None
        enc.encode(START + (i + 1) * 10**9, float(i % 9), annotation=note)
    return [enc.stream()] + _mixed_random()[:7]


def _wide_records(int_optimized=True):
    # nanosecond streams whose deltas jump by up to 2**40 ns (64-bit dods)
    # carrying random floats, ~130 bits a record: a run of records goes past
    # what a series' ring holds ahead of its cursor, so fetches read the row
    rng = np.random.default_rng(12)
    out = []
    for _ in range(6):
        enc = jm.Encoder(START, int_optimized=int_optimized, default_unit=JUnit.NANOSECOND)
        t = START
        for v in rng.normal(0, 1e6, 60):
            t += int(rng.integers(1, 2**40))
            enc.encode(t, float(v), unit=JUnit.NANOSECOND)
        out.append(enc.stream())
    return out


def _tu_change_at_flush():
    # time-unit markers on the records either side of each flush of 8, 16
    # and 32 records (7, 8, 15, 16, 31, 32, 63, 64): a marker's record is the
    # last of one flush or the first of the next
    enc = jm.Encoder(START)
    changes = {7, 8, 15, 16, 31, 32, 63, 64}
    unit = JUnit.SECOND
    for i in range(80):
        if i in changes:
            unit = JUnit.MILLISECOND if unit == JUnit.SECOND else JUnit.SECOND
        enc.encode(START + (i + 1) * 10**9, float(i % 11), unit=unit)
    return [enc.stream()] + _mixed_random()[:3]


# name -> (streams, max_points or None (the most records), int_optimized
# modes, default unit, words kept a row or None (all), host-codec parity)
CASES = {
    "mixed_random": (_mixed_random, None, (True,), JUnit.SECOND, None, True),
    "time_unit_change": (_time_unit_change, None, (True,), JUnit.SECOND, None, True),
    "unaligned_start_marker": (_unaligned_start_marker, None, (True,), JUnit.SECOND, None, True),
    "ns_64bit_bucket": (_ns_bucket, None, (True,), JUnit.NANOSECOND, None, True),
    "special_floats_int": (lambda: _special_floats(True), None, (True,), JUnit.SECOND, None, True),
    "special_floats_float": (lambda: _special_floats(False), None, (False,), JUnit.SECOND, None,
                             True),
    "repeats_and_mode_flips": (_repeats_and_mode_flips, None, (True,), JUnit.SECOND, None, True),
    "ragged_with_empty": (_ragged_with_empty, 100, (True,), JUnit.SECOND, None, True),
    "annotation_err": (_annotation, 4, (True,), JUnit.SECOND, None, False),
    "values_f32": (_sine, 20, (True,), JUnit.SECOND, None, True),
    "float_random": (_float_random, None, (False, True), JUnit.SECOND, None, False),
    "synthetic_mixed": (_synthetic_mixed, None, (True, False), JUnit.SECOND, None, False),
    # past every stream's end: EOS ends each, later records are invalid
    "beyond_records": (_mixed_random, 150, (True, False), JUnit.SECOND, None, True),
    # no zero words after the longest stream: its fetches past the end
    # repeat its last data word (the clamp)
    "min_words": (_mixed_random, 150, (True, False), JUnit.SECOND, -2, False),
    # rows cut below the streams: every fetch past W - 1 repeats word W - 1
    "truncated_words": (_synthetic_mixed, 70, (True, False), JUnit.SECOND, 9, False),
    "one_word": (_sine, 25, (True, False), JUnit.SECOND, 1, False),
    # a last flush of one record (121 = 15 x 8 + 1 = 7 x 16 + 9)
    "partial_flush": (_mixed_random, 121, (True, False), JUnit.SECOND, None, True),
    "long_annotation": (_long_annotation, None, (True,), JUnit.SECOND, None, False),
    "wide_records": (_wide_records, None, (True,), JUnit.NANOSECOND, None, True),
    "wide_records_float": (lambda: _wide_records(False), None, (False,), JUnit.NANOSECOND, None,
                           True),
    "tu_change_at_flush": (_tu_change_at_flush, None, (True,), JUnit.SECOND, None, True),
}

_cache = {}


def _inputs(name):
    """(streams, numpy words, num_bits, initial_unit, max_points)."""
    if name not in _cache:
        make, maxp, modes, unit, keep, _ = CASES[name]
        streams = make()
        seg = JBatched.from_streams(streams)
        words = seg.words
        if keep is not None:
            words = np.ascontiguousarray(words[:, :keep])
        if maxp is None:
            maxp = max((len(jm.decode(s, int_optimized=modes[0], default_unit=unit))
                        for s in streams if s), default=1)
        _cache[name] = (streams, words, seg.num_bits, seg.initial_units(unit), maxp)
    return _cache[name]


def _tensors(words, num_bits, initial_unit):
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
    return put(np.asarray(words, np.uint32)), put(np.asarray(num_bits, np.int32)), put(
        np.asarray(initial_unit, np.int32))


def _i64(hi, lo):
    return ((np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)).view(np.int64)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.ts.numpy(), _i64(want.ts_hi, want.ts_lo))
    np.testing.assert_array_equal(got.bits.numpy(), _i64(want.val_hi, want.val_lo))
    for f in ("point_is_float", "mult", "valid", "err"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.values_f32.numpy().view(np.int32),
                                  np.asarray(want.values_f32).view(np.int32))


MODES = [(name, io) for name, case in CASES.items() for io in case[2]]


@pytest.mark.parametrize("name,int_optimized", MODES)
def test_decode_batched_matches_jax(name, int_optimized):
    _, words, nb, iu, maxp = _inputs(name)
    want = jdecode.decode_batched(words, nb, iu, max_points=maxp, int_optimized=int_optimized)
    got = tdecode.decode_batched(*_tensors(words, nb, iu), maxp, int_optimized=int_optimized)
    assert got.ts.shape == (words.shape[0], maxp) and got.values_f32.dtype == torch.float32
    _assert_same(got, want)
    if name == "annotation_err":
        assert bool(got.err[0]) and not got.valid[0].any()
    if name in ("beyond_records", "min_words") and int_optimized:
        # the int streams decode in their own mode: EOS ends each
        assert not got.valid[:, -1].any() and got.valid.any()


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
def test_decode_batched_matches_host_codec(name):
    """The reference test's oracle: the port's decode, finalized, equals the
    port's host codec point for point (f64 bits, NaN-safe)."""
    streams, words, nb, iu, maxp = _inputs(name)
    _, _, modes, unit, _, _ = CASES[name]
    io = modes[0]
    res = tdecode.decode_batched(*_tensors(words, nb, iu), maxp, int_optimized=io)
    assert not res.err.any()
    ts_out, vals_out, valid = (x.numpy() for x in tdecode.finalize_decode(res))
    for i, data in enumerate(streams):
        exp = tm.decode(data, int_optimized=io, default_unit=Unit(int(unit))) if data else []
        assert valid[i].sum() == len(exp)
        for j, dp in enumerate(exp):
            assert ts_out[i, j] == dp.timestamp
            assert struct.pack("<d", dp.value) == struct.pack("<d", float(vals_out[i, j]))


def test_values_f32_close():
    _, words, nb, iu, maxp = _inputs("values_f32")
    res = tdecode.decode_batched(*_tensors(words, nb, iu), maxp)
    want = np.array([math.sin(i / 3.0) * 100 for i in range(20)], np.float32)
    np.testing.assert_allclose(res.values_f32[0].numpy(), want, rtol=1e-5)


def test_decode_batched_rejects_bad_inputs():
    w, nb, iu = _tensors(np.zeros((2, 3), np.uint32), np.zeros(2), np.zeros(2))
    with pytest.raises(TypeError):
        tdecode.decode_batched(w.to(torch.int64), nb, iu, 4)
    with pytest.raises(ValueError):
        tdecode.decode_batched(w, nb[:1], iu, 4)
    with pytest.raises(ValueError):
        tdecode.decode_batched(w, nb, iu, 0)


@pytest.fixture(scope="module")
def host_batched(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = str(tmp_path_factory.mktemp("batched_host") / "lane_aggregates_host.so")
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, str(_build.SOURCES["lane_aggregates"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    lib.m3_decode_batched_host_far_fetches.restype = ctypes.c_int64
    lib.m3_decode_batched_shape.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    fn = lib.m3_decode_batched_host
    fn.lib = lib
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return fn


def host_decode(fn, words, num_bits, initial_unit, t, int_optimized):
    """Kernel B-6's host build on int32 tensors -> a DecodeResult."""
    s, w = words.shape
    ts, bits = np.zeros((s, t), np.int64), np.zeros((s, t), np.int64)
    small, err = np.zeros((3, s, t), np.uint8), np.zeros(s, np.uint8)
    f32 = np.zeros((s, t), np.float32)
    wn, nbn, iun = (np.ascontiguousarray(x.numpy()) for x in (words, num_bits, initial_unit))
    rc = fn(wn.ctypes.data, nbn.ctypes.data, iun.ctypes.data, s, w, t, int(int_optimized),
            ts.ctypes.data, bits.ctypes.data, small[0].ctypes.data, small[1].ctypes.data,
            small[2].ctypes.data, err.ctypes.data, f32.ctypes.data)
    assert rc == 0
    b = lambda x: torch.from_numpy(x != 0)
    return tdecode.DecodeResult(ts=torch.from_numpy(ts), bits=torch.from_numpy(bits),
                                point_is_float=b(small[0]), mult=torch.from_numpy(small[1]),
                                valid=b(small[2]), err=b(err), values_f32=torch.from_numpy(f32))


@pytest.mark.parametrize("name,int_optimized", MODES)
def test_kernel_b6_source_host_build_matches_twin(host_batched, name, int_optimized):
    _, words, nb, iu, maxp = _inputs(name)
    args = _tensors(words, nb, iu)
    got = host_decode(host_batched, *args, maxp, int_optimized)
    want = tdecode.decode_batched(*args, maxp, int_optimized=int_optimized)
    for f in ("ts", "bits", "point_is_float", "mult", "valid", "err"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.values_f32.view(torch.int32), want.values_f32.view(torch.int32))


# runs of records around B-6's flushes (every 8, 16 or 32 records, the u8
# planes every 32, 64 or 128): a last flush of 1 record, of a group less
# one, a whole group
FLUSH_EDGES = [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129]


@pytest.mark.parametrize("t", FLUSH_EDGES)
def test_kernel_b6_host_build_flush_edges(host_batched, t):
    """The host build == the twin at every run length around a flush, on 64
    mixed streams (two warps: floats, counters, unit changes, annotations),
    in both modes."""
    _, words, nb, iu, _ = _inputs("synthetic_mixed")
    args = _tensors(words, nb, iu)
    for io in (True, False):
        got = host_decode(host_batched, *args, t, io)
        want = tdecode.decode_batched(*args, t, int_optimized=io)
        for f in ("ts", "bits", "point_is_float", "mult", "valid", "err"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (f, io)
        assert torch.equal(got.values_f32.view(torch.int32), want.values_f32.view(torch.int32))


def test_kernel_b6_host_build_reads_past_the_ring(host_batched):
    """Records wider than a ring holds ahead are read from the row (the
    host build counts those fetches), and still equal the twin; the gauge
    streams of the scan never leave the ring."""
    lib = host_batched.lib
    for name in ("wide_records", "wide_records_float"):
        _, words, nb, iu, maxp = _inputs(name)
        io = CASES[name][2][0]
        args = _tensors(words, nb, iu)
        got = host_decode(host_batched, *args, maxp, io)
        assert lib.m3_decode_batched_host_far_fetches() > 0, name
        want = tdecode.decode_batched(*args, maxp, int_optimized=io)
        assert torch.equal(got.bits, want.bits) and torch.equal(got.ts, want.ts)
    seg = tsyn.tiled_batch(40, 720, n_unique=8, seed=3)
    host_decode(host_batched, *_tensors(seg.words, seg.num_bits, seg.initial_units()), 720, True)
    assert lib.m3_decode_batched_host_far_fetches() == 0


def test_kernel_b6_host_build_shape(host_batched):
    """The geometry B-6's card build reports (the host build reports the
    same constants, and 0 for what only the card knows)."""
    out = (ctypes.c_int64 * 9)()
    assert host_batched.lib.m3_decode_batched_shape(1000, out) == 0
    warps, blocks, _, smem, _, _, group, flag_group, ring = list(out)
    assert blocks == -(-1000 // (32 * warps))
    assert flag_group % group == 0 and flag_group % 16 == 0 and ring & (ring - 1) == 0
    assert smem == warps * 32 * (ring * 4 + (group + 1) * 16 + flag_group + 4)


def test_segment_roundtrip_container():
    s = tm.encode_series([START + 10**9, START + 2 * 10**9], [1.0, 2.0], start_nanos=START)
    seg = TBatched.from_streams([s, b"ab"])
    assert seg.stream(0) == s
    assert seg.stream(1) == b"ab"
    assert seg.num_series == 2 and seg.num_words == seg.words.shape[1]


@pytest.mark.parametrize("name", ["mixed_random", "synthetic_mixed", "ragged_with_empty"])
def test_batched_segments_match_jax(name):
    streams = _inputs(name)[0]
    got, want = TBatched.from_streams(streams), JBatched.from_streams(streams)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.num_bits, want.num_bits)
    for unit in (JUnit.SECOND, JUnit.MILLISECOND, JUnit.NANOSECOND):
        np.testing.assert_array_equal(got.initial_units(Unit(int(unit))),
                                      want.initial_units(unit))
    np.testing.assert_array_equal(got.initial_units(), want.initial_units())
    padded = TBatched.from_streams(streams, pad_words=300)
    np.testing.assert_array_equal(padded.words, JBatched.from_streams(streams, 300).words)


def test_unaligned_start_is_unitless():
    streams = _unaligned_start_marker() + _mixed_random()[:2]
    assert TBatched.from_streams(streams).initial_units().tolist() == [0, 1, 1]
    assert TBatched.from_streams([b"ab"]).initial_units().tolist() == [0]


@pytest.mark.parametrize("kind", ["gauge", "counter", "float"])
def test_tiled_batch_matches_jax(kind):
    got = tsyn.tiled_batch(200, 30, n_unique=16, seed=4, kind=kind)
    want = jsyn.tiled_batch(200, 30, n_unique=16, seed=4, kind=kind)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.num_bits, want.num_bits)
    np.testing.assert_array_equal(got.initial_units(), want.initial_units())
    assert got.num_series == 200 and np.array_equal(got.words[16], got.words[0])
