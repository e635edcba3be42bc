"""Port parity for the write path's device encode (m3_tpu_torch.ops.encode,
kernel B-4) and born-resident admission, on the CPU, against m3_tpu.

- The twin's words, total_bits, chunk_offs and chunk_sigs equal
  ``m3_tpu.ops.encode.encode_lanes`` under JAX on the CPU bit for bit, the
  rows past a lane's last chunk included, on single-point lanes, repeats,
  the int tracker's fall-and-recover and >= 5-repeat cases, every dod
  opcode (the 32-bit one too), NaN/inf float lanes, contained and
  uncontained XORs, and the reference's own generators (every case of
  tests/test_encode.py).
- ``classify_lane`` / ``probe_is_float`` equal the reference's on edge
  values (+-0, NaN, +-inf, the 2^31 edges, sub-second and unsorted times),
  and the batch ``classify_lanes`` equals ``classify_lane`` lane by lane.
- ``streams()`` equals the host codec (both packages' ``encode_series``)
  and decodes back; ``side_rows_for`` equals m3_tpu's.
- A fileset written from device streams and side rows is byte-identical to
  the all-host one with fallback lanes in the block.
- ``admit_block_device`` on the port's pool equals m3_tpu's: page words,
  side pages, entries, counters, host riders.
- B-4's host build (g++) equals the twin.
- The device-ingest Database: the port's == m3_tpu's == the port's host
  seal on filesets, reads and stats; acknowledged device-ingest writes
  replay from the commit log after a hard kill.

The JAX encode compiles once for each (T_pad, W, k): the cases keep to
T_pad 8, 64 and 256.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from m3_tpu.cache.block_cache import BlockKey as JBlockKey
from m3_tpu.codec.m3tsz import encode_series as j_encode_series
from m3_tpu.ops import encode as jenc
from m3_tpu.resident.pool import ResidentOptions as JOptions
from m3_tpu.resident.pool import ResidentPool as JPool
from m3_tpu.utils.instrument import Registry as JRegistry
from m3_tpu_torch.cache.block_cache import BlockKey
from m3_tpu_torch.codec.m3tsz import Encoder, ReaderIterator, encode_series
from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops import encode as tenc
from m3_tpu_torch.resident import ResidentOptions, ResidentPool
from m3_tpu_torch.storage.fs import FilesetID, FilesetReader, write_fileset
from m3_tpu_torch.utils.instrument import Registry
from m3_tpu_torch.utils.xtime import Unit
from torch_streams import b4_lanes

NANOS = 1_000_000_000
BS = 1_700_000_000 * NANOS


def _int_lane(rng, n):
    t = BS + np.cumsum(rng.integers(1, 30, n)) * NANOS
    v = rng.integers(-5000, 5000, n).astype(np.float64)
    return t.astype(np.int64), v


def _float_lane(rng, n):
    t = BS + np.cumsum(rng.integers(1, 30, n)) * NANOS
    v = rng.normal(0, 10, n)
    return t.astype(np.int64), v


def _times(steps):
    return (BS + np.cumsum(np.asarray(steps, np.int64)) * NANOS).astype(np.int64)


def _edge_lanes(rng):
    """Lanes that reach each rule of the encoder."""
    n = 60
    regular = _times(np.full(n, 10))
    # every dod opcode: 0, 7-bit, 9-bit, 12-bit and 32-bit, both signs
    dod_steps = np.cumsum([10, 0, 5, -60, 200, -250, 1500, -2000, 100000, -99990, 3, 0, 1])
    dod_steps = np.abs(dod_steps) + 1
    lanes = [
        (regular[:1], np.asarray([0.0])),  # single point, int 0 (2-bit header)
        (regular[:1], np.asarray([-3.0])),  # single point, negative int
        (regular[:1], np.asarray([np.pi])),  # single point float
        (regular[:1], np.asarray([np.nan])),  # single NaN
        (regular, np.full(n, 7.0)),  # int repeats throughout
        (regular, np.full(n, np.e)),  # float repeats throughout
        # the tracker: a big diff, then >= 5 small ones (it falls), then up
        (regular, np.cumsum([100000, 1, 1, 1, 1, 1, 1, 1, 50000, 2, 2, 2, 2, 2, 2, 0, 0, 1,
                             -70000, 3, 3, 3, 3, 3, 3, 3, 3, 1, 1] + [0] * 31).astype(float)),
        # falls then recovers before 5 (the counter resets)
        (regular, np.cumsum([4096, 2, 2, 2, 5000, 2, 2, 2, 2, 2, 2, 2, 0, 0, 0, 2, 2, 2, 2, 2]
                            + list(rng.integers(-3, 4, n - 20))).astype(float)),
        (_times(dod_steps), np.arange(len(dod_steps), dtype=float)),
        (_times(dod_steps), rng.normal(0, 1, len(dod_steps))),
        # NaN / inf in a float lane, and repeats of them
        (regular[:12], np.asarray([np.nan, np.nan, np.pi, np.inf, np.inf, np.e, -np.pi * 1e10, np.nan,
                                   1e300 / 3, -1e-300 / 3, np.sqrt(2), np.sqrt(2)])),
        # the int32 edges: |v| = 2^31 - 1, diffs up to 2^31 - 1
        (regular[:7], np.asarray([2**31 - 1, 0, 2**31 - 1, 1, 0, -(2**31 - 1), 0], float)),
        (regular[:3], np.asarray([-(2**31 - 1), -5, 0], float)),
        # XORs in the same bit window (contained) and moving (uncontained)
        (regular, np.concatenate([np.pi + np.arange(20) * 2.0**-40, rng.normal(0, 1e6, 40)])),
    ]
    return lanes


def _lanes_case(name):
    if name.startswith("roundtrip"):  # tests/test_encode.py's roundtrip lanes
        rng = np.random.default_rng(int(name[9:]))
        return [(_int_lane if i % 2 else _float_lane)(rng, int(rng.integers(1, 200)))
                for i in range(8)]
    if name.startswith("bytes"):  # tests/test_encode.py's stream-bytes lanes
        rng = np.random.default_rng(int(name[5:]))
        return [(_int_lane if i % 3 else _float_lane)(rng, int(rng.integers(1, 150)))
                for i in range(6)]
    rng = np.random.default_rng({"edges": 3, "ragged": 7, "mixed": 23, "short": 1}[name])
    if name == "edges":
        return _edge_lanes(rng)
    if name == "ragged":
        return [(_int_lane if i % 2 else _float_lane)(rng, int(rng.integers(1, 200)))
                for i in range(20)]
    if name == "mixed":
        return [(_int_lane if i % 3 else _float_lane)(rng, int(rng.integers(1, 150)))
                for i in range(12)]
    return [(_int_lane if i % 2 else _float_lane)(rng, int(rng.integers(1, 8)))
            for i in range(9)]


CASES = ["edges", "ragged", "mixed", "short", "roundtrip1", "roundtrip7", "roundtrip23", "bytes3",
         "bytes13"]


def _kinds(lanes):
    return np.asarray([jenc.classify_lane(t, v, np.ones(len(t), np.int8)).kind
                       for t, v in lanes], np.int8)


def _decode(stream):
    it = ReaderIterator(stream)
    out = []
    while it.next():
        out.append(it.current())
    assert it.err is None or isinstance(it.err, EOFError)
    return out


@pytest.mark.parametrize("k", [32, 8])
@pytest.mark.parametrize("name", CASES)
def test_twin_matches_reference_bit_for_bit(name, k):
    lanes = _lanes_case(name)
    kinds = _kinds(lanes)
    assert (kinds != jenc.KIND_NONE).all(), kinds
    want = jenc.encode_lanes(lanes, kinds, k=k)
    got = tenc.encode_lanes(lanes, kinds, k=k, device="cpu")
    assert got.words.dtype == torch.int32
    assert np.array_equal(got.words.numpy().view(np.uint32), np.asarray(want.words))
    for f in ("total_bits", "nbytes", "chunk_offs", "chunk_sigs", "n_chunks", "kinds", "counts"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the rows past each lane's last chunk are outputs too
    if name != "short" and got.chunk_offs.shape[0] > 1:  # T_pad 8: one chunk row
        assert got.chunk_offs.shape[0] > int(got.n_chunks.min())


def test_twin_matches_reference_with_page_rounding():
    lanes = _lanes_case("ragged")
    kinds = _kinds(lanes)
    want = jenc.encode_lanes(lanes, kinds, k=32, round_words_to=512)
    got = tenc.encode_lanes(lanes, kinds, k=32, round_words_to=512, device="cpu")
    assert got.words.shape == tuple(want.words.shape) and got.words.shape[1] % 512 == 0
    assert np.array_equal(got.words.numpy().view(np.uint32), np.asarray(want.words))


def test_twin_in_lane_passes_matches_one_pass():
    inp = tenc.encode_inputs(_lanes_case("ragged"), _kinds(_lanes_case("ragged")), device="cpu")
    for a, b in zip(tenc.encode_reference(inp), tenc.encode_reference(inp, lanes_a_pass=3)):
        assert torch.equal(a, b)


def test_words_bound_and_bucket_are_the_reference():
    for t in (1, 7, 8, 9, 100, 720, 1024):
        assert tenc.t_bucket(t) == max(8, 1 << int(np.ceil(np.log2(t))))
        for r in (1, 16, 512):
            assert tenc.words_bound(t, r) == jenc.words_bound(t, r)


EDGE_VALUES = [0.0, -0.0, np.nan, np.inf, -np.inf, 2.0**31 - 1, 2.0**31, -(2.0**31 - 1), -(2.0**31),
               2.0**63, -(2.0**63), 1e13, 1.5, 0.1, 1e-300, 5e-324, 123456.789, -7.0, 9.999999]


def test_probe_is_float_matches_reference():
    rng = np.random.default_rng(0)
    v = np.concatenate([EDGE_VALUES, rng.normal(0, 1e6, 200), np.round(rng.normal(0, 100, 200), 2)])
    assert np.array_equal(tenc.probe_is_float(v), jenc.probe_is_float(v))


def _classify_cases():
    t = _times(np.full(8, 10))
    cases = [(t[:0], np.zeros(0), np.zeros(0))]
    for val in EDGE_VALUES:
        cases.append((t[:3], np.asarray([1.0, val, 2.0]), np.ones(3)))
        cases.append((t[:2], np.asarray([val, val]), np.ones(2)))
    cases += [
        (t, np.arange(8.0), np.asarray([1, 1, 1, 2, 1, 1, 1, 1])),  # a unit change
        (t + 1, np.arange(8.0), np.ones(8)),  # sub-second start
        (np.r_[t[:4], t[4:] + 500_000], np.arange(8.0), np.ones(8)),  # sub-second later
        (t[::-1].copy(), np.arange(8.0), np.ones(8)),  # unsorted
        (np.r_[t[:4], t[3:7]], np.arange(8.0), np.ones(8)),  # a duplicate time
        (np.asarray([-NANOS, 0, NANOS], np.int64), np.arange(3.0), np.ones(3)),  # negative start
        (np.asarray([0, NANOS, 2**62], np.int64), np.arange(3.0), np.ones(3)),  # dod overflow
        (t[:3], np.asarray([2.0**31 - 1, -(2.0**31 - 1), 0.0]), np.ones(3)),  # diff overflow
        (t[:3], np.asarray([1.0, 1.5, 2.0]), np.ones(3)),  # mixed modes
        (t, np.round(np.linspace(-3, 3, 8), 3), np.ones(8)),
    ]
    return cases


def test_classify_lane_matches_reference():
    for t, v, u in _classify_cases():
        assert tenc.classify_lane(t, v, u) == tuple(jenc.classify_lane(t, v, u)), (t, v, u)


def test_classify_lanes_batch_equals_lane_by_lane():
    cases = _classify_cases() + [(t, v, np.ones(len(t))) for t, v in _lanes_case("edges")]
    counts = np.asarray([len(c[0]) for c in cases])
    got = tenc.classify_lanes(np.concatenate([c[0] for c in cases]),
                              np.concatenate([c[1] for c in cases]),
                              np.concatenate([c[2] for c in cases]), counts)
    want = np.asarray([jenc.classify_lane(*c).kind for c in cases], np.int8)
    assert np.array_equal(got, want)
    assert set(want.tolist()) == {jenc.KIND_NONE, jenc.KIND_INT, jenc.KIND_FLOAT}


@pytest.mark.parametrize("name", CASES)
def test_streams_match_host_codec_and_roundtrip(name):
    lanes = _lanes_case(name)
    res = tenc.encode_lanes(lanes, _kinds(lanes), device="cpu")
    for (t, v), stream in zip(lanes, res.streams()):
        ts, vs = [int(x) for x in t], [float(x) for x in v]
        assert stream == encode_series(ts, vs) == j_encode_series(ts, vs)
        dps = _decode(stream)
        assert [d.timestamp for d in dps] == ts
        assert np.array_equal(np.asarray([d.value for d in dps]), v, equal_nan=True)


@pytest.mark.parametrize("name", ["edges", "ragged"])
def test_side_rows_match_reference(name):
    lanes = _lanes_case(name)
    kinds = _kinds(lanes)
    got = tenc.side_rows_for(tenc.encode_lanes(lanes, kinds, device="cpu"), lanes, BS)
    want = jenc.side_rows_for(jenc.encode_lanes(lanes, kinds), lanes, BS)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b)
    res = tenc.encode_lanes(lanes, kinds, device="cpu")
    jres = jenc.encode_lanes(lanes, kinds)
    assert [tenc.lane_max_span(res, m) for m in range(len(lanes))] == \
        [jenc.lane_max_span(jres, m) for m in range(len(lanes))]


def test_encode_block_matches_reference():
    rng = np.random.default_rng(2)
    points = [(t, v, np.ones(len(t), np.int8)) for t, v in _lanes_case("short")]
    mt = _times(rng.integers(1, 20, 30))
    points.insert(2, (mt, np.where(np.arange(30) % 2 == 0, rng.normal(0, 5, 30),
                                   np.arange(30, dtype=np.float64)), np.ones(30, np.int8)))
    kinds, res, idx, side = tenc.encode_block(points, BS, device="cpu")
    jkinds, jres, jidx, jside = jenc.encode_block(points, BS)
    assert np.array_equal(kinds, jkinds) and np.array_equal(idx, jidx)
    assert idx[2] == -1 and kinds[2] == tenc.KIND_NONE
    assert np.array_equal(res.words.numpy().view(np.uint32), np.asarray(jres.words))
    assert all(np.array_equal(a, b) for a, b in zip(side, jside))
    assert tenc.encode_lanes([], [], device="cpu") is None


def test_encode_input_checks():
    lanes = _lanes_case("short")
    inp = tenc.encode_inputs(lanes, _kinds(lanes), device="cpu")
    with pytest.raises(ValueError, match="int32"):
        tenc.encode_planes(inp._replace(dod=inp.dod.to(torch.int64)))
    with pytest.raises(ValueError, match="words"):
        tenc.encode_planes(inp._replace(words=1))
    with pytest.raises(ValueError, match="card"):  # the kernel takes planes on a card only
        tenc.launch_encode(inp)


def _annotated_stream(t0):
    enc = Encoder(t0)
    enc.encode(t0, 1.5, annotation=b"meta")
    enc.encode(t0 + NANOS, 2.5)
    enc.encode(t0 + 3 * NANOS, 2.5, annotation=b"more")
    return enc.stream()


def _unit_change_stream(t0):
    enc = Encoder(t0)
    enc.encode(t0, 4.0, unit=Unit.SECOND)
    enc.encode(t0 + 2 * NANOS, 5.0, unit=Unit.MILLISECOND)
    enc.encode(t0 + 3 * NANOS, 6.0, unit=Unit.MILLISECOND)
    return enc.stream()


def test_fileset_byte_identity_with_fallback_lanes(tmp_path):
    """One block mixing device lanes with every fallback class: the fileset
    written from device streams + packed side rows is byte-identical to the
    all-host one, and the device lanes read back through it."""
    rng = np.random.default_rng(5)
    lanes = [_int_lane(rng, 40), _float_lane(rng, 70)]
    res = tenc.encode_lanes(lanes, [tenc.KIND_INT, tenc.KIND_FLOAT], device="cpu")
    streams = res.streams()
    rows = tenc.side_rows_for(res, lanes, BS)
    n = 50
    mt = BS + np.cumsum(rng.integers(1, 20, n)) * NANOS
    mv = np.where(np.arange(n) % 2 == 0, rng.normal(0, 5, n), np.arange(n, dtype=np.float64))
    assert tenc.classify_lane(mt.astype(np.int64), mv, np.ones(n, np.int8)).kind == \
        tenc.KIND_NONE
    series = {
        b"int": streams[0],
        b"float": streams[1],
        b"mixed": encode_series([int(x) for x in mt], [float(x) for x in mv]),
        b"unitchange": _unit_change_stream(BS + NANOS),
        b"annotated": _annotated_stream(BS + NANOS),
    }
    write_fileset(str(tmp_path), FilesetID("ns", 0, BS, 0), series, 2 * 3600 * NANOS, 32)
    write_fileset(str(tmp_path), FilesetID("ns", 1, BS, 0), series, 2 * 3600 * NANOS, 32,
                  side_rows={b"int": rows[0], b"float": rows[1]})
    base_h = os.path.join(str(tmp_path), "data", "ns", "0")
    base_d = os.path.join(str(tmp_path), "data", "ns", "1")
    assert sorted(os.listdir(base_h)) == sorted(os.listdir(base_d))
    for name in os.listdir(base_h):
        with open(os.path.join(base_h, name), "rb") as fh, \
                open(os.path.join(base_d, name), "rb") as fd:
            assert fh.read() == fd.read(), name
    reader = FilesetReader(str(tmp_path), FilesetID("ns", 1, BS, 0))
    for sid, (t, v) in ((b"int", lanes[0]), (b"float", lanes[1])):
        dps = _decode(reader.stream(sid))
        assert [d.timestamp for d in dps] == [int(x) for x in t]
        assert np.array_equal(np.asarray([d.value for d in dps]), v)


def _pools(opts_kw, prefix):
    return (JPool(JOptions(**opts_kw), registry=JRegistry(f"j{prefix}_")),
            ResidentPool(ResidentOptions(**opts_kw), registry=Registry(f"t{prefix}_"),
                         device="cpu"))


def _dev_items(res, side, n):
    return [(bytes([i]), i, int(res.nbytes[i]), int(res.n_chunks[i]),
             tenc.lane_max_span(res, i), side[i]) for i in range(n)]


def _assert_pools_equal(jp, tp, keys):
    jw, jsd = np.asarray(jp._words), np.asarray(jp._side)
    tw, tsd = tp._words.numpy().view(np.uint32), tp._side.numpy().view(np.uint32)
    for key in keys:
        je, te = jp.get(JBlockKey(*key)), tp.get(BlockKey(*key))
        assert (je.nbytes, je.num_bits, je.n_chunks, je.chunk_k, je.max_span_bits) == \
            (te.nbytes, te.num_bits, te.n_chunks, te.chunk_k, te.max_span_bits)
        assert (je.pages, je.side_pages) == (te.pages, te.side_pages)
        assert np.array_equal(np.concatenate([jw[p] for p in je.pages]),
                              np.concatenate([tw[p] for p in te.pages])), key
        if je.side_pages:
            assert np.array_equal(np.concatenate([jsd[p] for p in je.side_pages]),
                                  np.concatenate([tsd[p] for p in te.side_pages])), key
    js, ts = jp.stats(), tp.stats()
    for f in ("entries", "bytes", "pages_used", "side_pages_used", "complete_blocks",
              "admissions", "rejections", "upload_bytes", "device_admissions",
              "inplace_admissions", "side_pack_overflows"):
        assert js[f] == ts[f], f


def test_admit_block_device_matches_reference_zero_upload():
    """Born-resident admission: the port's pool holds the reference's pages,
    side pages and entries, with no stream byte uploaded, and the same pages
    as the host upload of the same streams."""
    rng = np.random.default_rng(7)
    lanes = [(_int_lane if i % 2 else _float_lane)(rng, int(rng.integers(1, 200)))
             for i in range(9)]
    kinds = _kinds(lanes)
    kw = dict(max_bytes=1 << 22, side_bytes=1 << 20)
    pw = ResidentOptions(**kw).page_words
    res = tenc.encode_lanes(lanes, kinds, k=32, round_words_to=pw, device="cpu")
    jres = jenc.encode_lanes(lanes, kinds, k=32, round_words_to=pw)
    side = tenc.side_rows_for(res, lanes, BS)
    jp, tp = _pools(kw, "adm")
    r = tp.admit_block_device("ns", 0, BS, 1, res.words, _dev_items(res, side, 9), chunk_k=32)
    jr = jp.admit_block_device("ns", 0, BS, 1, jres.words, [
        (bytes([i]), i, int(jres.nbytes[i]), int(jres.n_chunks[i]), jenc.lane_max_span(jres, i),
         jenc.side_rows_for(jres, lanes, BS)[i]) for i in range(9)], chunk_k=32)
    assert tuple(r) == tuple(jr) and r.complete and r.admitted == 9
    keys = [("ns", 0, bytes([i]), BS, 1) for i in range(9)]
    _assert_pools_equal(jp, tp, keys)
    st = tp.stats()
    assert st["upload_bytes"] == 0 and st["device_admissions"] == 9
    n_side = sum(len(tp.get(BlockKey(*k)).side_pages) for k in keys)
    assert st["ingest_side_stage_bytes"] == n_side * tp.options.side_page_bytes > 0
    # the same streams uploaded from the host give the same page words
    hp = ResidentPool(ResidentOptions(**kw), device="cpu")
    streams = res.streams()
    assert hp.admit_block("ns", 0, BS, 1, [(bytes([i]), streams[i], len(lanes[i][0]))
                                           for i in range(9)], chunk_k=32).complete
    for k in keys:
        eh, ed = hp.get(BlockKey(*k)), tp.get(BlockKey(*k))
        assert torch.equal(hp._words[list(eh.pages)], tp._words[list(ed.pages)])
        assert torch.equal(hp._side[list(eh.side_pages)], tp._side[list(ed.side_pages)])
    assert hp.stats()["upload_bytes"] > 0


def test_admit_block_device_host_riders_match_reference():
    """Host-fallback lanes ride the same batch (completeness over the
    union), paying their own upload only."""
    rng = np.random.default_rng(11)
    lanes = [_int_lane(rng, int(rng.integers(5, 120))) for _ in range(5)]
    kinds = [tenc.KIND_INT] * 5
    kw = dict(max_bytes=1 << 22, side_bytes=1 << 20)
    pw = ResidentOptions(**kw).page_words
    res = tenc.encode_lanes(lanes, kinds, k=32, round_words_to=pw, device="cpu")
    jres = jenc.encode_lanes(lanes, kinds, k=32, round_words_to=pw)
    side = tenc.side_rows_for(res, lanes, BS)
    n = 60
    ht = BS + np.cumsum(rng.integers(1, 30, n)) * NANOS
    hv = np.where(np.arange(n) % 2 == 0, rng.normal(0, 5, n), np.arange(n, dtype=np.float64))
    hstream = encode_series([int(x) for x in ht], [float(x) for x in hv])
    riders = [(b"\x05", hstream, n), (b"\x06", b"", 0)]
    jp, tp = _pools(kw, "ride")
    r = tp.admit_block_device("ns", 0, BS, 1, res.words, _dev_items(res, side, 5), chunk_k=32,
                              host_items=riders)
    jr = jp.admit_block_device("ns", 0, BS, 1, jres.words, [
        (bytes([i]), i, int(jres.nbytes[i]), int(jres.n_chunks[i]), jenc.lane_max_span(jres, i),
         jenc.side_rows_for(jres, lanes, BS)[i]) for i in range(5)], chunk_k=32,
        host_items=riders)
    assert tuple(r) == tuple(jr) and r.complete and r.admitted == 6
    _assert_pools_equal(jp, tp, [("ns", 0, bytes([i]), BS, 1) for i in range(6)])
    assert 0 < tp.upload_bytes == len(tp.get(BlockKey("ns", 0, b"\x05", BS, 1)).pages) * pw * 4
    assert tp.device_admissions == 5 and tp.is_complete("ns", 0, BS, 1)


def test_admit_block_device_span_budget_and_width_checks():
    rng = np.random.default_rng(12)
    lanes = [_float_lane(rng, 200) for _ in range(3)]
    kinds = [tenc.KIND_FLOAT] * 3
    kw = dict(max_bytes=1 << 16, page_words=16, max_lane_pages=4)
    res = tenc.encode_lanes(lanes, kinds, k=32, round_words_to=16, device="cpu")
    jres = jenc.encode_lanes(lanes, kinds, k=32, round_words_to=16)
    side = tenc.side_rows_for(res, lanes, BS)
    jp, tp = _pools(kw, "span")
    r = tp.admit_block_device("ns", 0, BS, 1, res.words, _dev_items(res, side, 3))
    jr = jp.admit_block_device("ns", 0, BS, 1, jres.words, _dev_items(jres, side, 3))
    assert tuple(r) == tuple(jr) and r.rejected_span == 3 and not r.complete
    assert tp.never_completable("ns", 0, BS, 1)
    bad = tenc.encode_lanes(lanes, kinds, k=32, device="cpu")
    from m3_tpu_torch.resident import ResidentPoolError

    with pytest.raises(ResidentPoolError, match="page_words"):
        tp.admit_block_device("ns", 0, BS, 2, bad.words, _dev_items(bad, side, 3))
    off = ResidentPool(ResidentOptions(max_bytes=0), device="cpu")
    assert off.admit_block_device("ns", 0, BS, 1, res.words, []) == (0, 0, 0, False)


def test_admit_block_device_under_lease_writes_a_copy():
    rng = np.random.default_rng(13)
    lanes = [_int_lane(rng, 50) for _ in range(2)]
    kw = dict(max_bytes=1 << 20)
    pw = ResidentOptions(**kw).page_words
    res = tenc.encode_lanes(lanes, [tenc.KIND_INT] * 2, round_words_to=pw, device="cpu")
    side = tenc.side_rows_for(res, lanes, BS)
    pool = ResidentPool(ResidentOptions(**kw), device="cpu")
    pool.admit_block("ns", 0, BS - 1, 0, [(b"x", res.streams()[0], 50)])
    with pool.read_lease():
        before = pool._words
        snap = before.clone()
        assert pool.admit_block_device("ns", 0, BS, 0, res.words,
                                       _dev_items(res, side, 2)).complete
        assert torch.equal(before, snap) and pool._words is not before
    assert pool.stats()["copy_admissions"] == 1


@pytest.fixture(scope="module")
def host_encode(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "encode_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["encode"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.m3_encode_lanes_host.argtypes = [P, P, P, P, P, I64, I64, I, I64, I64, P, P, P, P]
    return lib


@pytest.mark.parametrize("k", [32, 5, 1])
@pytest.mark.parametrize("name", CASES + ["steps", "straddle", "opcodes"])
def test_b4_host_build_matches_twin(host_encode, name, k):
    """The host build runs the kernel's steps of 32 records (lanes of a
    warp one after the other) and stores every word of its rows: == the
    twin, its words filled with -1 first; on the reference's cases and on
    torch_streams.b4_lanes' lanes of 31-97 records, tracker falls
    straddling a step and every dod opcode (records of five words), whose
    rows are not a multiple of 4 words."""
    own = name in ("steps", "straddle", "opcodes")  # rows of W words, not a multiple of 4
    lanes = b4_lanes(name) if own else _lanes_case(name)
    inp = tenc.encode_inputs(lanes, _kinds(lanes), k=k, round_words_to=1 if own else 16,
                             device="cpu")
    T, M = inp.dod.shape
    C = (T + k - 1) // k
    out = (torch.full((M, inp.words), -1, dtype=torch.int32), torch.empty(M, dtype=torch.int32),
           torch.empty((C, M), dtype=torch.int32), torch.empty((C, M), dtype=torch.int32))
    rc = host_encode.m3_encode_lanes_host(
        inp.t0.data_ptr(), inp.counts.data_ptr(), inp.float_lane.data_ptr(), inp.dod.data_ptr(),
        inp.vbits.data_ptr(), M, T, k, inp.words, C, *(o.data_ptr() for o in out))
    assert rc == 0
    for got, want in zip(out, tenc.encode_reference(inp)):
        assert torch.equal(got, want)
    assert host_encode.m3_encode_lanes_host(
        inp.t0.data_ptr(), inp.counts.data_ptr(), inp.float_lane.data_ptr(), inp.dod.data_ptr(),
        inp.vbits.data_ptr(), M, T, k, inp.words, C + 1, *(o.data_ptr() for o in out)) == -1


# ---------------------------------------------------------------------------
# the device-ingest Database
# ---------------------------------------------------------------------------


def _e2e_entries():
    bsz = 2 * 3600 * NANOS
    rng = np.random.default_rng(17)
    entries = []
    for s in range(12):
        sid = f"series-{s}".encode()
        n = int(rng.integers(20, 120))
        t0 = bsz + int(rng.integers(0, 100)) * NANOS
        ts = t0 + np.cumsum(rng.integers(1, 30, n)) * NANOS
        if s % 3 == 0:
            vals = rng.integers(-500, 500, n).astype(np.float64)
        elif s % 3 == 1:
            vals = rng.normal(0, 10, n)
        else:
            vals = np.where(rng.random(n) < 0.5, rng.integers(0, 9, n), rng.normal(0, 1, n))
        entries += [(sid, int(t), float(v)) for t, v in zip(ts.tolist(), vals.tolist())]
    # an out-of-order point and a duplicate make dirty lanes
    entries.append((b"series-1", int(bsz + 3 * NANOS), 0.5))
    entries.append(entries[5])
    return bsz, entries


def _files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            if "commitlog" not in path:
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = fh.read()
    return out


def test_database_device_ingest_end_to_end(tmp_path):
    """The port's device-ingest node == m3_tpu's device-ingest node == the
    port's host node: every fileset file byte-identical, every read equal;
    the device node admits with fewer upload bytes (only fallback lanes
    pay) and the same admissions."""
    from m3_tpu.ingest import IngestOptions as JIngestOptions
    from m3_tpu.resident.pool import ResidentOptions as JResOpts
    from m3_tpu.storage.database import Database as JDatabase
    from m3_tpu.storage.database import NamespaceOptions as JNamespaceOptions
    from m3_tpu_torch.ingest import IngestOptions
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    bsz, entries = _e2e_entries()
    dbs = {
        "jdev": JDatabase(str(tmp_path / "jdev"), num_shards=4, commitlog_enabled=False,
                          resident_options=JResOpts(enabled=True, max_bytes=1 << 22),
                          ingest_options=JIngestOptions()),
        "dev": Database(str(tmp_path / "dev"), num_shards=4, commitlog_enabled=False,
                        resident_options=ResidentOptions(enabled=True, max_bytes=1 << 22),
                        ingest_options=IngestOptions(), device="cpu"),
        "host": Database(str(tmp_path / "host"), num_shards=4, commitlog_enabled=False,
                         resident_options=ResidentOptions(enabled=True, max_bytes=1 << 22),
                         device="cpu"),
    }
    for name, db in dbs.items():
        db.create_namespace("metrics", (JNamespaceOptions if name == "jdev" else
                                        NamespaceOptions)(block_size_nanos=bsz))
        db.bootstrapped = True
        db.write_batch("metrics", list(entries[:-20]))
        for sid, t, v in entries[-20:]:
            db.write("metrics", sid, t, v)
        assert db.flush("metrics", 2 * bsz)
    want = _files(str(tmp_path / "jdev"))
    assert want and _files(str(tmp_path / "dev")) == want == _files(str(tmp_path / "host"))
    for s in range(12):
        sid = f"series-{s}".encode()
        reads = [[(d.timestamp, d.value) for d in db.read("metrics", sid, 0, 4 * bsz)]
                 for db in dbs.values()]
        assert reads[0] and reads[0] == reads[1] == reads[2]
    # the files read across the two packages both ways
    from m3_tpu.storage.fs import FilesetID as JFilesetID
    from m3_tpu.storage.fs import FilesetReader as JFilesetReader

    for shard in range(4):
        jr = JFilesetReader(str(tmp_path / "dev"), JFilesetID("metrics", shard, bsz, 0))
        tr = FilesetReader(str(tmp_path / "jdev"), FilesetID("metrics", shard, bsz, 0))
        assert sorted(jr.series_ids) == sorted(tr.series_ids)
        for sid in tr.series_ids:
            assert jr.stream(sid) == tr.stream(sid)
    st = {name: db.resident_pool.stats() for name, db in dbs.items()}
    assert st["dev"]["device_admissions"] == st["jdev"]["device_admissions"] > 0
    assert st["host"]["device_admissions"] == 0
    assert st["dev"]["upload_bytes"] == st["jdev"]["upload_bytes"] < st["host"]["upload_bytes"]
    assert st["dev"]["admissions"] == st["jdev"]["admissions"] == st["host"]["admissions"]
    assert st["dev"]["ingest_side_stage_bytes"] > 0
    shards = dbs["dev"].namespaces["metrics"].shards
    jshards = dbs["jdev"].namespaces["metrics"].shards
    for sh, jsh in zip(shards, jshards):
        assert sh.ingest.stats() == jsh.ingest.stats()
    assert sum(sh.ingest.stats()["dirty_lane_fallbacks"] for sh in shards) >= 1
    assert sum(sh.seal_seconds["encode"] for sh in shards) > 0
    for db in dbs.values():
        db.close()


def test_database_device_ingest_tick_drops_expired_windows(tmp_path):
    from m3_tpu_torch.ingest import IngestOptions
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    bsz = 2 * 3600 * NANOS
    db = Database(str(tmp_path), num_shards=1, commitlog_enabled=False,
                  ingest_options=IngestOptions(), device="cpu")
    db.create_namespace("m", NamespaceOptions(retention_nanos=4 * bsz, block_size_nanos=bsz))
    db.bootstrapped = True
    db.write_batch("m", [(b"a", bsz + NANOS, 1.0), (b"a", 2 * bsz + NANOS, 2.0)])
    # tagged writes reach the buffer through Shard.write
    assert db.write_tagged_batch("m", [(((b"k", b"v"),), bsz + 2 * NANOS, 3.0, 1)]) == [None]
    sh = db.namespaces["m"].shards[0]
    assert sh.ingest.open_windows() == [bsz, 2 * bsz]
    assert sh.ingest.stats()["appends"] == 3
    db.tick(6 * bsz)
    assert sh.ingest.open_windows() == [2 * bsz]
    db.close()


def test_device_ingest_writes_survive_hard_kill(tmp_path):
    """Mirror of tests/test_storage_faults.py: every acknowledged write
    through the device-ingest path (spill lanes and dirty tails included)
    replays from the commit log bit for bit after a hard kill."""
    from m3_tpu_torch.ingest import IngestOptions
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    t0 = 1_600_000_000 * NANOS
    bsz = 2 * 3600 * NANOS
    opts = NamespaceOptions(retention_nanos=48 * 3600 * NANOS, block_size_nanos=bsz)
    db = Database(str(tmp_path / "live"), num_shards=2, device="cpu",
                  ingest_options=IngestOptions(lanes=4, slots=8, sync_batch=4))
    db.create_namespace("t", opts)
    db.bootstrap()
    entries = []
    for s in range(12):  # 12 series > 4 lanes: spill lanes
        sid = f"series-{s}".encode()
        for i in range(12):  # 12 points > 8 slots: dirty tails
            entries.append((sid, t0 + (i * 7 + s) * NANOS, float(s * 100 + i)))
    db.write_batch("t", entries[: len(entries) // 2])
    for sid, t, v in entries[len(entries) // 2:]:
        db.write("t", sid, t, v)
    db.flush_wals()
    expected = {f"series-{s}".encode(): db.read("t", f"series-{s}".encode(), t0, t0 + bsz)
                for s in range(12)}
    assert all(len(v) == 12 for v in expected.values())
    spills = [sh.ingest.stats()["spills"] for sh in db.namespaces["t"].shards]
    assert sum(sp["lanes"] for sp in spills) > 0 and sum(sp["slots"] for sp in spills) > 0
    for cl in db._commitlogs.values():
        cl._crash()
    shutil.copytree(str(tmp_path / "live"), str(tmp_path / "copy"))
    db2 = Database(str(tmp_path / "copy"), num_shards=2, device="cpu")
    db2.create_namespace("t", opts)
    db2.bootstrap()
    for sid, want in expected.items():
        assert db2.read("t", sid, t0, t0 + bsz) == want, sid
    db2.close()
