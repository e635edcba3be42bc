"""Port parity for the device column write buffer (m3_tpu_torch.ingest),
on the CPU, against m3_tpu.ingest driven with the same batches:

- accepted masks, spills by reason (window, lanes, slots), clean and dirty
  lanes, ``stats`` (device syncs and their bytes included) and ``epoch``;
- ``window_planes``: the four u32 column planes and the counts after each
  sync, bit for bit, and the lane sid lists;
- ``seal_window``'s clean lanes and dirty sids, ``drop_window`` and
  ``open_windows``;
- the lease: a sync under a lease writes a copy, so the reader's planes
  stay as they were; without one it writes them in place.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from m3_tpu.ingest import ColumnWriteBuffer as JBuffer
from m3_tpu.ingest import IngestOptions as JOptions
from m3_tpu.utils.instrument import Registry as JRegistry
from m3_tpu_torch.ingest import SPILL_REASONS, ColumnWriteBuffer, IngestOptions
from m3_tpu_torch.utils.instrument import Registry

NANOS = 1_000_000_000
BSZ = 2 * 3600 * NANOS
B0 = 800_000 * BSZ


def _pair(prefix, **kw):
    return (JBuffer(JOptions(**kw), BSZ, registry=JRegistry(f"j{prefix}_")),
            ColumnWriteBuffer(IngestOptions(**kw), BSZ, registry=Registry(f"t{prefix}_"),
                              device="cpu"))


def _batches(seed, n_batches=6, n_series=12, per=20, windows=3):
    """Write batches over a few windows: in-order rows, a few out-of-order
    and duplicate rows, several series and windows in one batch."""
    rng = np.random.default_rng(seed)
    out = []
    clock = np.zeros(n_series, np.int64)
    for b in range(n_batches):
        sids, times, values = [], [], []
        for _ in range(per):
            s = int(rng.integers(0, n_series))
            w = int(rng.integers(0, windows)) if b % 2 else b % windows
            step = int(rng.integers(1, 30))
            clock[s] += step
            t = B0 + w * BSZ + int(clock[s]) * NANOS
            if rng.random() < 0.1:
                t -= 40 * NANOS  # out of order
            sids.append(f"s{s}".encode())
            times.append(t)
            values.append(float(rng.normal(0, 10)) if s % 2 else float(rng.integers(0, 100)))
        if b == 3:  # a duplicate row
            sids.append(sids[0])
            times.append(times[0])
            values.append(values[0])
        out.append((sids, np.asarray(times, np.int64), np.asarray(values),
                    np.ones(len(times), np.int8)))
    return out


def _assert_planes_equal(jb, tb, bs):
    jw, tw = jb.window_planes(bs), tb.window_planes(bs)
    assert (jw is None) == (tw is None)
    if jw is None:
        return
    (jv, jsids), (tv, tsids) = jw, tw
    assert jsids == tsids
    for name in ("ts_hi", "ts_lo", "val_hi", "val_lo", "counts"):
        want = np.asarray(jv[name])
        got = tv[name].numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got.view(want.dtype), want), name


@pytest.mark.parametrize("kw", [
    dict(lanes=16, slots=64, windows=2, sync_batch=8),
    dict(lanes=4, slots=8, windows=2, sync_batch=4),  # every spill reason
    dict(lanes=32, slots=128, windows=3, sync_batch=1 << 20),  # explicit syncs only
])
@pytest.mark.parametrize("seed", [1, 2])
def test_buffer_matches_reference(kw, seed):
    jb, tb = _pair(f"m{seed}{kw['lanes']}", **kw)
    for sids, times, values, units in _batches(seed):
        a = jb.append_batch(sids, times, values, units)
        b = tb.append_batch(sids, times, values, units)
        assert np.array_equal(a, b)
        assert jb.stats() == tb.stats()
        assert jb.open_windows() == tb.open_windows()
        for bs in jb.open_windows():
            _assert_planes_equal(jb, tb, bs)
    assert jb.sync() == tb.sync()
    assert jb.stats() == tb.stats() and jb.epoch == tb.epoch
    for bs in jb.open_windows():
        _assert_planes_equal(jb, tb, bs)
    # single-row appends go the same way
    assert jb.append(b"late", B0 + 5 * NANOS, 1.0, 1) == tb.append(b"late", B0 + 5 * NANOS, 1.0, 1)
    for bs in jb.open_windows():
        jc, jd = jb.seal_window(bs)
        tc, td = tb.seal_window(bs)
        assert jd == td and len(jc) == len(tc)
        for x, y in zip(jc, tc):
            assert x.sid == y.sid and set(x) == set(y)
            for f in ("times", "values", "units"):  # x.values is dict's method
                assert x[f].dtype == y[f].dtype and np.array_equal(x[f], y[f]), f
        assert tb.window_planes(bs) is None
    assert jb.stats() == tb.stats() and tb.open_windows() == []
    assert tb.seal_window(B0) == ([], [])


def test_spill_reasons_and_counters():
    jb, tb = _pair("sp", lanes=2, slots=3, windows=1, sync_batch=1 << 20)
    rows = ([b"a", b"a", b"a", b"a", b"b", b"c"],
            np.asarray([B0 + i * NANOS for i in (1, 2, 3, 4, 1, 1)], np.int64),
            np.arange(6.0), np.ones(6, np.int8))
    assert np.array_equal(jb.append_batch(*rows), tb.append_batch(*rows))
    nxt = ([b"a"], np.asarray([B0 + BSZ], np.int64), np.zeros(1), np.ones(1, np.int8))
    assert not tb.append_batch(*nxt)[0]
    jb.append_batch(*nxt)
    assert tb.stats()["spills"] == jb.stats()["spills"] == {"window": 1, "lanes": 1, "slots": 1}
    assert tuple(tb.stats()["spills"]) == SPILL_REASONS
    off = ColumnWriteBuffer(IngestOptions(enabled=False), BSZ, device="cpu")
    assert not off.append_batch(*rows).any() and off.stats()["appends"] == 0
    with pytest.raises(ValueError, match="positive"):
        IngestOptions(lanes=0)


def test_drop_window_releases_frame_and_planes():
    jb, tb = _pair("dr", lanes=8, slots=16, windows=2, sync_batch=1)
    for b in (jb, tb):
        b.append_batch([b"x", b"y"], np.asarray([B0 + NANOS, B0 + BSZ + NANOS]),
                       np.asarray([1.0, 2.0]), np.ones(2, np.int8))
    _assert_planes_equal(jb, tb, B0)
    for b in (jb, tb):
        b.drop_window(B0)
    assert jb.open_windows() == tb.open_windows() == [B0 + BSZ]
    assert tb.window_planes(B0) is None
    assert jb.stats() == tb.stats()


def test_sync_under_lease_writes_a_copy():
    tb = ColumnWriteBuffer(IngestOptions(lanes=4, slots=8, sync_batch=1 << 20), BSZ,
                           device="cpu")
    tb.append_batch([b"a"], np.asarray([B0 + NANOS]), np.asarray([1.0]), np.ones(1, np.int8))
    tb.sync()
    view, _ = tb.window_planes(B0)
    cols_before = tb._planes[B0]["cols"]
    tb.append_batch([b"a"], np.asarray([B0 + 2 * NANOS]), np.asarray([2.0]), np.ones(1, np.int8))
    with tb.lease():
        snap = view["ts_lo"].clone()
        tb.sync()
        assert torch.equal(view["ts_lo"], snap)  # the reader's planes did not move
        assert tb._planes[B0]["cols"] is not cols_before
    view2, _ = tb.window_planes(B0)
    assert int(view2["counts"][0]) == 2
    # without a lease the planes are written in place
    cols = tb._planes[B0]["cols"]
    tb.append_batch([b"a"], np.asarray([B0 + 3 * NANOS]), np.asarray([3.0]), np.ones(1, np.int8))
    tb.sync()
    assert tb._planes[B0]["cols"] is cols and int(tb._planes[B0]["counts"][0]) == 3


def test_lease_waits_for_an_inplace_sync():
    tb = ColumnWriteBuffer(IngestOptions(lanes=4, slots=8), BSZ, device="cpu")
    entered = threading.Event()
    with tb._lock:
        tb._donating = True

    def reader():
        with tb.lease():
            entered.set()

    th = threading.Thread(target=reader)
    th.start()
    assert not entered.wait(0.2)
    with tb._lock:
        tb._donating = False
        tb._fence.notify_all()
    assert entered.wait(5)
    th.join()
    assert tb._leases == 0
