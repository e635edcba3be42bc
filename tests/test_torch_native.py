"""Port parity for the host codec library (m3_tpu_torch/native/, built from
m3_tpu_torch/native/m3tsz.cc by g++ on the CPU).

Mirrors tests/test_native.py and holds every entry point to both
``m3_tpu.native`` (the JAX package's library) and ``m3_tpu``'s Python codec
on the same numpy-seeded inputs: encoded bytes, snapshot records, decoded
triples (NaN bits included) and shard ids identical. Also the edges the
reference's tests leave out: empty and one-point streams,
``int_optimized=False``, per-point units, k=24, a too-small ``max_points``,
corrupt streams, the encoder's error input (where the reference's library
dereferences a null scheme, so it is held to the Python encoder only), the
int32 window-key guard, and where the library and its source live.
"""

import ctypes
import re

import numpy as np
import pytest

from m3_tpu import native as jnative
from m3_tpu.codec.m3tsz import Encoder as JEncoder
from m3_tpu.codec.m3tsz import decode as jdecode
from m3_tpu.codec.m3tsz import encode_series as jencode_series
from m3_tpu.ops.chunked import snapshot_stream as jsnapshot_stream
from m3_tpu.utils.hash import shard_for as jshard_for
from m3_tpu.utils.xtime import Unit as JUnit
from m3_tpu_torch import native
from m3_tpu_torch.aggregator import kernels as agg_kernels
from m3_tpu_torch.codec.m3tsz import Encoder, encode_series
from m3_tpu_torch.ops import _build, chunked, decode, fused
from m3_tpu_torch.utils.hash import shard_for
from m3_tpu_torch.utils.xtime import _UNIT_NANOS, Unit

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
INT32_MAX = np.iinfo(np.int32).max
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 5e-324, 1e300, -2.5]


@pytest.fixture(scope="module", autouse=True)
def _reference_library():
    if not jnative.available():
        pytest.fail("m3_tpu's native library did not build: the oracle is missing")


def _series(seed, n, kind="gauge"):
    rng = np.random.default_rng(seed)
    ts = T0 + np.cumsum(rng.integers(1, 30, n)) * NANOS
    if kind == "gauge":
        vals = np.round(rng.normal(100, 30, n), 2)
    elif kind == "float":
        vals = rng.normal(0, 1, n)
    elif kind == "specials":
        # a finite first value: a first -inf is where the reference's two
        # codecs part (its Python encoder raises OverflowError, its library
        # casts -inf to int64)
        vals = np.asarray([0.5] + [SPECIALS[(j * 3 + seed) % len(SPECIALS)] for j in range(n)])[:n]
    else:
        vals = np.cumsum(rng.integers(0, 1000, n)).astype(np.float64)
    return ts.astype(np.int64), vals


def _py_streams(series, int_optimized=True):
    return [jencode_series(t.tolist(), v.tolist(), int_optimized=int_optimized) for t, v in series]


def _mixed_streams():
    """Streams of every length class and a stream with annotations and
    time-unit changes (the prescan and the decoder must walk them)."""
    streams = [b"", jencode_series([T0], [1.5])]
    for i, n in enumerate([3, 40, 100]):
        t, v = _series(10 + i, n)
        streams.append(jencode_series(t.tolist(), v.tolist()))
    # 24 int records, then floats: the chunk at record 24 holds float records
    # only but starts in int mode, so it is not float-fast
    t, v = _series(13, 64, "float")
    streams.append(jencode_series(t.tolist(), [float(j) for j in range(24)] + v[24:].tolist()))
    enc = JEncoder(T0)
    t = T0
    for j in range(30):
        unit = JUnit.SECOND if j % 11 else JUnit.MILLISECOND
        t += NANOS if unit == JUnit.SECOND else 500_000_000
        enc.encode(t, float(j), unit=unit, annotation=b"meta" if j == 7 else None)
    streams.append(enc.stream())
    return streams


def _same_triple(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))  # NaN bits too


@pytest.mark.parametrize("int_optimized", [True, False])
@pytest.mark.parametrize("kind", ["gauge", "float", "counter", "specials"])
def test_encode_batch_bit_exact(kind, int_optimized):
    lengths = [0, 1, 5, 64, 133]
    series = [_series(i, n, kind) for i, n in enumerate(lengths)]
    args = (np.concatenate([t for t, _ in series]), np.concatenate([v for _, v in series]),
            np.asarray(lengths, np.int32))
    got = native.encode_batch(*args, int_optimized=int_optimized)
    assert got == jnative.encode_batch(*args, int_optimized=int_optimized)
    assert got == _py_streams(series, int_optimized)
    assert got[0] == b""


def test_encode_batch_mixed_precision_values():
    # values that exercise int->float->int transitions and repeats
    t = T0 + np.arange(20, dtype=np.int64) * NANOS
    v = np.asarray([1.0, 2.0, 2.0, 0.1234567890123, 4.0, 4.0, 1e300, -5.5, 7.0, 7.0] * 2)
    [stream] = native.encode_batch(t, v, np.asarray([20], np.int32))
    assert stream == jencode_series(t.tolist(), v.tolist())
    assert stream == jnative.encode_batch(t, v, np.asarray([20], np.int32))[0]
    assert [dp.value for dp in jdecode(stream)] == v.tolist()


@pytest.mark.parametrize("int_optimized", [True, False])
@pytest.mark.parametrize("k", [4, 24, 32])
def test_prescan_batch_matches(k, int_optimized):
    if int_optimized:
        streams = _mixed_streams()
    else:
        streams = [b""] + _py_streams([_series(30 + i, n, "float") for i, n in
                                       enumerate([1, 7, 90])], int_optimized=False)
    got = native.prescan_batch(streams, k=k, int_optimized=int_optimized)
    assert got == jnative.prescan_batch(streams, k=k, int_optimized=int_optimized)
    want = [jsnapshot_stream(s, k, int_optimized=int_optimized) for s in streams]
    assert got == want
    ref = jnative.prescan_batch(streams[-1:], k=k, int_optimized=int_optimized)[0]
    ref_keys = [list(p) for p in ref]
    assert [list(p) for p in got[-1]] == ref_keys  # the reference binding's key order
    assert got[0] == [] and len(got[1]) == 1


def test_prescan_build_chunked_records_round_trip():
    """The library's prescan -> build_chunked -> the records twin decodes
    every stream to the Python decoder's points; the batch equals the one
    assembled from the Python prescan field by field."""
    k = 16
    streams = [s for s in _mixed_streams() if s][:-1]  # without the annotated stream
    streams += _py_streams([_series(20 + i, 50 + i * 17, kind) for i, kind in
                            enumerate(["gauge", "float", "counter", "specials"])])
    batch = chunked.build_chunked(streams, k=k)
    plain = chunked.assemble_chunked(streams, [chunked.snapshot_stream(s, k) for s in streams], k)
    for f in chunked.LANE_FIELDS:
        g, w = getattr(batch, f), getattr(plain, f)
        if f in chunked.STATE_PAIR_FIELDS:
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]), f
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), f
    assert np.array_equal(batch.fast, plain.fast)
    assert np.array_equal(batch.fast_float, plain.fast_float)
    p = fused.pack_lanes(batch, order="s", rows=8, device="cpu")
    res = chunked.decode_chunked(p.windows, p.lanes, batch.num_series, batch.num_chunks, k)
    ts, vals, valid = decode.finalize_decode(res)
    for i, s in enumerate(streams):
        want = jdecode(s)
        got_t = ts[i][valid[i]].numpy()
        got_v = vals[i][valid[i]].numpy()
        assert got_t.tolist() == [d.timestamp for d in want]
        assert np.array_equal(got_v.view(np.int64),
                              np.asarray([d.value for d in want], np.float64).view(np.int64))


def test_pack_windowed_dense_matches_numpy():
    """m3agg_* fused densify == the port's numpy window_keys +
    pack_dense_groups == m3_tpu's library, including clamped out-of-range
    samples (in-window offsets past the resolution stress the torder
    downshift) and NaN values (which occupy a slot but are invalid)."""
    rng = np.random.default_rng(11)
    g, nw, per = 500, 4, 6
    n = g * nw * per
    t0, res = 1_700_000_000 * NANOS, 60 * NANOS
    ids = rng.integers(0, g, n).astype(np.int64)
    times = t0 + rng.integers(0, nw * res, n)
    late = rng.random(n) < 0.01
    times[late] += rng.integers(2, 200, late.sum()) * res
    times[rng.random(n) < 0.005] -= 3 * res  # before the first window
    values = rng.normal(0, 1, n).astype(np.float32)
    values[rng.random(n) < 0.02] = np.nan

    keys, _, order = agg_kernels.window_keys(ids, times, t0, res, nw)
    v1, t1, m1 = agg_kernels.pack_dense_groups(keys, values, order, g * nw)
    for v2, t2, m2 in (native.pack_windowed_dense(ids, times, values, t0, res, nw, g),
                       jnative.pack_windowed_dense(ids, times, values, t0, res, nw, g)):
        assert v1.shape == v2.shape
        assert np.array_equal(m1, m2)
        assert np.array_equal(v1.view(np.int32), v2.view(np.int32))
        occupied = np.arange(v1.shape[1])[None, :] < np.bincount(keys, minlength=g * nw)[:, None]
        assert np.array_equal(t1[occupied], t2[occupied])


def test_window_grid_past_int32_takes_numpy_route(monkeypatch):
    """A grid of more than INT32_MAX groups goes to the int64-keyed numpy
    path, as the reference routes it; the library is not called."""
    nw = 4
    n_series = INT32_MAX // nw + 2
    ids = np.asarray([0, n_series - 1], np.int64)
    times = np.asarray([T0, T0 + 3 * 60 * NANOS], np.int64)
    seen = {}

    def numpy_pack(keys, values, order, n_groups):
        seen.update(keys=keys, n_groups=n_groups)
        return "numpy route"

    monkeypatch.setattr(agg_kernels, "pack_dense_groups", numpy_pack)
    monkeypatch.setattr(native, "load", lambda: pytest.fail("the library was called"))
    out = native.pack_windowed_dense(ids, times, np.ones(2, np.float32), T0, 60 * NANOS, nw,
                                     n_series)
    assert out == "numpy route"
    assert seen["n_groups"] == n_series * nw > INT32_MAX
    assert seen["keys"].dtype == np.int64
    assert seen["keys"].tolist() == [0, (n_series - 1) * nw + 3]


@pytest.mark.parametrize("last_id,raises", [(INT32_MAX // 4 + 1, True), (INT32_MAX // 4, False)])
def test_window_keys_raw_entry_refuses_int32_wrap(last_id, raises):
    """m3agg_window_keys refuses a key past INT32_MAX (the reference's
    library wraps it negative); the largest key that fits passes."""
    ids = np.asarray([0, last_id], np.int64)
    times = np.asarray([T0, T0 + 3 * 60 * NANOS], np.int64)
    if raises:
        with pytest.raises(ValueError, match="INT32_MAX"):
            native.window_keys(ids, times, T0, 60 * NANOS, 4)
    else:
        keys, torder = native.window_keys(ids, times, T0, 60 * NANOS, 4)
        assert keys.tolist() == [0, last_id * 4 + 3] == [0, INT32_MAX]
        assert torder.tolist() == [0, 0]
    with pytest.raises(ValueError):
        native.window_keys(ids, times, T0, 0, 4)
    with pytest.raises(ValueError, match="outside"):  # an id past n_series
        native.pack_windowed_dense(np.asarray([0, 5]), times, np.ones(2, np.float32), T0,
                                   60 * NANOS, 4, n_series=1)


@pytest.mark.parametrize("int_optimized", [True, False])
def test_decode_batch_matches_python(int_optimized):
    """m3tsz_decode_batch == the Python decoder on (t, v, unit), NaN bits
    included, with float/int mode switches, unit changes, empty and
    one-point streams; == m3_tpu's library."""
    rng = np.random.default_rng(3)
    series = []
    for kind in range(8):
        n = int(rng.integers(1, 200))
        times = T0 + np.cumsum(rng.integers(1, 30, n)) * NANOS
        if kind % 3 == 0:
            vals = rng.integers(0, 1000, n).astype(float)
        elif kind % 3 == 1:
            vals = rng.normal(0, 1e6, n)
        else:
            vals = np.where(rng.random(n) < 0.5, rng.integers(0, 9, n), rng.normal())
        series.append((times.astype(np.int64), vals))
    series.append(_series(5, 40, "specials"))
    series.append(_series(6, 1))
    streams = [b""] + _py_streams(series, int_optimized)
    if int_optimized:
        streams += [s for s in _mixed_streams() if s]
    got = native.decode_batch(streams, int_optimized=int_optimized)
    want = jnative.decode_batch(streams, int_optimized=int_optimized)
    assert len(got) == len(want) == len(streams)
    for s, g, w in zip(streams, got, want):
        _same_triple(g, w)
        dps = jdecode(s, int_optimized=int_optimized)
        py = (np.asarray([d.timestamp for d in dps], np.int64),
              np.asarray([d.value for d in dps], np.float64),
              np.asarray([int(d.unit) for d in dps], np.uint8))
        _same_triple(g, py)


def test_decode_batch_flags_annotations():
    enc = JEncoder(T0)
    enc.encode(T0, 1.0)
    enc.encode(T0 + NANOS, 2.0, annotation=b"meta")
    with_ann = enc.stream()
    plain = jencode_series([T0, T0 + NANOS], [1.0, 2.0])
    triples, flags = native.decode_batch([plain, with_ann], with_flags=True)
    assert list(flags) == [0, 1]
    assert list(flags) == list(jnative.decode_batch([plain, with_ann], with_flags=True)[1])
    # annotations do not perturb (t, v) decoding
    assert list(triples[1][0]) == [T0, T0 + NANOS]
    assert list(triples[1][1]) == [1.0, 2.0]
    assert native.decode_batch([], with_flags=True)[0] == []


def test_decode_batch_retries_too_small_max_points():
    streams = _py_streams([_series(40 + i, n) for i, n in enumerate([3, 50, 7])])
    full = native.decode_batch(streams)
    for got in (native.decode_batch(streams, max_points=8),
                jnative.decode_batch(streams, max_points=8)):
        for g, w in zip(got, full):
            _same_triple(g, w)
    assert [len(t) for t, _, _ in full] == [3, 50, 7]


def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


# a first timestamp off the default unit (no unit: no delta-of-delta scheme)
# and a first value whose multiplier (7) passes the format's 6
CORRUPT = {
    "no_scheme": _bits_to_bytes(format(T0 + 1, "064b") + "0" * 24),
    "bad_mult": _bits_to_bytes(format(T0, "064b") + "0" + "0" + "11" + format(3, "06b")
                               + "1" + "111" + "1" + "101" + "0" * 16),
}


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_decode_batch_corrupt_stream_raises(name):
    good = jencode_series([T0, T0 + NANOS], [1.0, 2.0])
    bad = CORRUPT[name]
    with pytest.raises(ValueError):
        jdecode(bad)
    for lib in (native, jnative):
        with pytest.raises(ValueError, match="decode failed for 1 streams"):
            lib.decode_batch([good, bad, good])
        with pytest.raises(ValueError):
            lib.decode_batch([bad], max_points=4)


def _units_case(name):
    """(times, values, units) of one series with per-point units."""
    n = 60
    rng = np.random.default_rng(8)
    if name == "mixed":
        units = rng.choice([1, 2, 3, 4], n).astype(np.int32)
        steps = np.asarray([_UNIT_NANOS[Unit(int(u))] for u in units]) * rng.integers(1, 9, n)
    elif name == "seconds_then_ms":
        units = np.where(np.arange(n) < n // 2, 1, 2).astype(np.int32)
        steps = np.where(units == 1, NANOS, 1_000_000) * rng.integers(1, 5, n)
    else:  # a time unit without a delta-of-delta scheme on its first point only
        units = np.asarray([int(name[-1])] + [1] * (n - 1), np.int32)
        steps = np.full(n, 60 * NANOS)
    times = T0 + np.cumsum(steps)
    return times.astype(np.int64), np.round(rng.normal(50, 9, n), 3), units


@pytest.mark.parametrize("name", ["mixed", "seconds_then_ms", "first_unit_5", "first_unit_8"])
def test_encode_one_per_point_units(name):
    t, v, u = _units_case(name)
    got = native.encode_one(t, v, u)
    enc = JEncoder(int(t[0]))
    for tt, vv, uu in zip(t.tolist(), v.tolist(), u.tolist()):
        enc.encode(tt, vv, unit=JUnit(uu))
    assert got == enc.stream()
    assert got == jnative.encode_one(t, v, u)
    port = Encoder(int(t[0]))
    for tt, vv, uu in zip(t.tolist(), v.tolist(), u.tolist()):
        port.encode(tt, vv, unit=Unit(uu))
    assert got == port.stream()
    assert native.encode_one(t[:0], v[:0]) == b""
    [triple] = native.decode_batch([got])
    assert triple[2].tolist() == u.tolist()


# inputs the Python encoder raises ValueError for (a point's unit without a
# time encoding scheme, after its unit's marker); m3_tpu's library
# dereferences a null scheme on them, so only its Python codec is the oracle
ENCODE_ERRORS = {"minutes": [5, 5], "hours_after_seconds": [1, 6, 6], "days": [7, 7, 7],
                 "none": [1, 0], "invalid_code": [1, 9]}


@pytest.mark.parametrize("name", sorted(ENCODE_ERRORS))
def test_encode_error_input_raises_like_the_reference(name):
    units = np.asarray(ENCODE_ERRORS[name], np.int32)
    t = T0 + np.arange(len(units), dtype=np.int64) * 3600 * NANOS
    v = np.arange(len(units), dtype=np.float64)
    with pytest.raises(ValueError):
        enc = JEncoder(int(t[0]))
        for tt, vv, uu in zip(t.tolist(), v.tolist(), units.tolist()):
            enc.encode(tt, vv, unit=JUnit(uu))
    with pytest.raises(ValueError):
        native.encode_one(t, v, units)


def test_encode_batch_error_input_raises_like_the_reference():
    t = T0 + np.arange(3, dtype=np.int64) * 60 * NANOS
    v = np.ones(3)
    with pytest.raises(ValueError):
        jencode_series(t.tolist(), v.tolist(), unit=JUnit.MINUTE)
    with pytest.raises(ValueError, match="no time encoding scheme"):
        native.encode_batch(t, v, np.asarray([3], np.int32), default_unit=int(Unit.MINUTE))
    with pytest.raises(ValueError):
        native.encode_batch(t, v, np.asarray([2], np.int32))


def test_shard_batch_matches_python_hash():
    """m3hash_shards == utils/hash murmur3 routing (both packages') and
    m3_tpu's library for every length class (block, 1-3 byte tails, empty)."""
    rng = np.random.default_rng(21)
    ids = [b"s%d" % i for i in range(2000)]
    ids += [bytes(rng.integers(0, 256, int(n))) for n in rng.integers(0, 40, 500)]
    ids += [b"", b"a", b"ab", b"abc", b"abcd", b"\xff" * 7]
    for num_shards in (1, 3, 64, 4096):
        out = native.shard_batch(ids, num_shards)
        assert out.dtype == np.int32
        assert np.array_equal(out, jnative.shard_batch(ids, num_shards))
        want = [shard_for(sid, num_shards) for sid in ids]
        assert out.tolist() == want == [jshard_for(sid, num_shards) for sid in ids]
    assert native.shard_batch([], 8).shape == (0,)
    with pytest.raises(ValueError):
        native.shard_batch(ids, 0)


def test_library_is_the_ports_own_build():
    """The library loads from a hash-named build of the port's copy of the
    source, under the build directory, never from native/."""
    source, flags, _ = _build.HOST_SOURCES["m3tsz"]
    pkg = _build.PKG
    assert source.resolve().is_relative_to(pkg) and source.exists()
    assert "-march=native" not in flags and "-ffp-contract=off" in flags
    path = _build.library_path("m3tsz")
    assert path.parent == _build.BUILD_DIR
    lib = native.load()
    assert lib._name == str(path) and path.exists()
    assert "native/libm3tsz" not in lib._name


def test_unit_codes_and_snapshot_layout_match():
    """The library's unit codes (unit_nanos) are utils/xtime's, and its
    49-byte snapshot record is the reference binding's."""
    text = _build.HOST_SOURCES["m3tsz"][0].read_text()
    body = re.search(r"int64_t unit_nanos\(int unit\) \{(.*?)\n\}", text, re.S).group(1)
    codes = {int(c): eval(e.replace("ll", "")) for c, e in re.findall(r"case (\d): return ([^;]+);",
                                                                        body)}
    assert codes == {int(u): n for u, n in _UNIT_NANOS.items()}
    assert ctypes.sizeof(native._SnapRec) == native.SNAP_DTYPE.itemsize == 49
    assert ctypes.sizeof(jnative._SnapRec) == 49
    for f, _ in jnative._SnapRec._fields_:
        assert getattr(native._SnapRec, f).offset == getattr(jnative._SnapRec, f).offset
        assert native.SNAP_DTYPE.fields[f][1] == getattr(jnative._SnapRec, f).offset
