"""Port parity for the host-to-device stream (m3_tpu_torch.parallel.stream).

The cases of tests/test_stream.py (totals against the chunked oracle, a
stream with no batch in flight, and the fileset route straight off the side
tables) run through the port's ``stream_aggregate`` on the CPU and through
``m3_tpu``'s: the count is exact, the sum within rtol 1e-6 (the reference's
tolerance: the oracle reduces a batch in another order than the packed
kernel's lanes), and the port's totals equal the fold of its own per-batch
``chunked_scan_aggregate_packed`` totals bit for bit. ``StreamTotals``
finalised mid-stream keeps folding.
"""

import numpy as np
import pytest
import torch

from m3_tpu.codec.m3tsz import encode_series as jencode
from m3_tpu.ops import chunked as jchunked
from m3_tpu.parallel import stream as jstream
from m3_tpu.storage import fs as jfs
from m3_tpu.utils import synthetic as jsyn
from m3_tpu_torch.codec.m3tsz import encode_series as tencode
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import fused as tfused
from m3_tpu_torch.parallel import scan as tscan
from m3_tpu_torch.parallel import stream as tstream
from m3_tpu_torch.storage import fs as tfs
from m3_tpu_torch.utils import synthetic as tsyn

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS


def _oracle(batches):
    """The chunked oracle (kernel R's twin + reductions), summed a batch at a
    time in f64 as tests/test_stream.py does."""
    total_sum, total_count = 0.0, 0
    for b in batches:
        packed = tfused.pack_lanes(b, order="s", device="cpu")
        out = tscan.chunked_scan_aggregate(packed, b.num_series, b.num_chunks, b.k)
        total_sum += float(out.total_sum)
        total_count += int(out.total_count)
    return total_sum, total_count


def _packed_fold(host_batches):
    """The fold of each batch's packed-scan totals, in f32 as StreamTotals
    folds them (count as int)."""
    acc, cnt = np.float32(0.0), 0
    for packed, s, c, k in host_batches:
        out = tscan.chunked_scan_aggregate_packed(packed, s=s, c=c, k=k)
        if int(out.total_count) > 0:
            acc = np.float32(acc + np.float32(float(out.total_sum)))
        cnt += int(out.total_count)
    return float(acc), cnt


def _batches(pkg, n_unique, n_points, seed, tile, n_batches):
    """``n_batches`` batches of other streams each (seeds ``seed``, ``seed
    + 1``, ...), so the fold sees which batch went where."""
    syn, ch = (tsyn, tchunked) if pkg == "torch" else (jsyn, jchunked)
    return [ch.tile_chunked(ch.build_chunked(syn.synthetic_streams(n_unique, n_points,
                                                                  seed=seed + i), k=8), tile)
            for i in range(n_batches)]


@pytest.mark.parametrize("prefetch,shape", [(2, (16, 60, 5, 64, 3)), (0, (8, 30, 6, 16, 2))])
def test_stream_totals_match_oracle_and_jax(prefetch, shape):
    batches = _batches("torch", *shape)
    drains = []
    got = tstream.stream_aggregate(tstream.packed_batches(batches), prefetch=prefetch,
                                   drain_times=drains, device="cpu")
    want = jstream.stream_aggregate(jstream.packed_batches(_batches("jax", *shape)),
                                    prefetch=prefetch)
    want_sum, want_count = _oracle(batches)
    assert got.batches == len(batches) and len(drains) == len(batches)
    assert got.total_count == want_count == want.total_count
    np.testing.assert_allclose(got.total_sum, want_sum, rtol=1e-6)
    np.testing.assert_allclose(got.total_sum, want.total_sum, rtol=1e-6)
    assert (got.total_sum, got.total_count) == _packed_fold(tstream.packed_batches(batches))
    assert got.total_min == pytest.approx(want.total_min, rel=1e-6)
    assert got.total_max == pytest.approx(want.total_max, rel=1e-6)


def _write(pkg, base):
    enc, fs = (jencode, jfs) if pkg == "jax" else (tencode, tfs)
    series = {
        f"s{i}".encode(): enc([T0 + j * NANOS for j in range(40)], [float(i + j) for j in range(40)])
        for i in range(20)
    }
    fid = fs.FilesetID("ns", 0, T0, 0)
    fs.write_fileset(str(base), fid, series, 2 * 3600 * NANOS, fs.CHUNK_K)
    return fs.FilesetReader(str(base), fid)


def test_fileset_to_stream_path(tmp_path):
    """Disk -> side tables -> packed batches -> kernel, no host prescan, in
    batches of 7 series with one in flight."""
    reader = _write("torch", tmp_path / "port")
    got = tstream.stream_aggregate(tstream.fileset_packed_batches([reader], batch_series=7),
                                   prefetch=1, device="cpu")
    want = jstream.stream_aggregate(
        jstream.fileset_packed_batches([_write("jax", tmp_path / "jax")], batch_series=7),
        prefetch=1)
    expect = sum(float(i + j) for i in range(20) for j in range(40))
    assert got.batches == 3
    assert got.total_count == want.total_count == 20 * 40
    np.testing.assert_allclose(got.total_sum, expect, rtol=1e-6)
    np.testing.assert_allclose(got.total_sum, want.total_sum, rtol=1e-6)
    assert (got.total_min, got.total_max) == (0.0, 58.0)


def test_finalize_mid_stream_keeps_folding():
    batches = _batches("torch", 8, 30, 7, 16, 3)
    packed = list(tstream.packed_batches(batches))
    totals = tstream.StreamTotals()
    assert totals.finalize() == (0.0, 0, float("inf"), float("-inf"))
    outs = [tscan.chunked_scan_aggregate_packed(p, s=s, c=c, k=k) for p, s, c, k in packed]
    totals.fold(outs[0])
    first = totals.finalize()
    assert first[1] == int(outs[0].total_count) and totals.batches == 1
    for out in outs[1:]:
        totals.fold(out)
    assert totals.total_count == sum(int(o.total_count) for o in outs) == 3 * first[1]
    assert totals.total_sum != first[0]
    whole = tstream.stream_aggregate(iter(packed), device="cpu")
    assert totals.finalize() == whole.finalize()


def test_stream_totals_skip_empty_batches():
    """A batch of empty series (count 0) adds nothing, its NaN extremes
    included."""
    empty = tchunked.build_chunked([b"", b""], k=8)
    full = _batches("torch", 4, 20, 3, 8, 1)[0]
    got = tstream.stream_aggregate(tstream.packed_batches([empty, full, empty]), device="cpu")
    alone = tstream.stream_aggregate(tstream.packed_batches([full]), device="cpu")
    assert got.batches == 3 and got.finalize() == alone.finalize()
    assert np.isfinite(got.total_min) and np.isfinite(got.total_max)
    assert isinstance(got.total_count, int) and torch.is_tensor(got._acc[1])
