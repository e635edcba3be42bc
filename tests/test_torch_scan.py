"""Port parity for the main path: m3_tpu_torch.parallel.scan
chunked_scan_aggregate_packed against m3_tpu's (Pallas kernel in interpret
mode), for each lane order, the compensated sums and the host stitch of
erred series.

Series counts are exact. The rest is held to rtol 1e-6 for series-major
lanes and 1e-5 for chunk-major ones: the lanes are bit-identical (see
test_torch_fused.py), but torch and XLA sum the per-lane values in
different orders, and chunk-major rows are strided (as test_fused.py:61,133
bounds the JAX package's own two layouts).
"""

import numpy as np
import pytest
import torch

from m3_tpu.codec.m3tsz import decode as jdecode
from m3_tpu.ops import chunked as jchunked
from m3_tpu.ops import fused as jfused
from m3_tpu.parallel import scan as jscan
from m3_tpu.utils import synthetic as jsyn
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import fused as tfused
from m3_tpu_torch.parallel import scan as tscan

K = 16


def _mixed(seed=5, n_unique=48, **kw):
    return jsyn.synthetic_mixed_streams(n_unique, 97, seed=seed, **kw)


def _both(streams, n_series, order, precise=False, rows=8):
    jb = jchunked.tile_chunked(jchunked.build_chunked(streams, k=K), n_series)
    jp = jfused.pack_lane_inputs(jb, order=order, rows=rows)
    want = jscan.chunked_scan_aggregate_packed(
        jp.windows4, jp.lanes4, jp.tile_flags, n=jp.n, s=n_series, c=jb.num_chunks, k=K,
        interpret=True, lane_order=order, inv=jp.inv, precise=precise,
    )
    tp = tfused.pack_lanes(tchunked.build_chunked(streams, k=K), order=order, rows=rows,
                           device="cpu", n_series=n_series)
    got = tscan.chunked_scan_aggregate_packed(tp, s=n_series, c=jb.num_chunks, k=K,
                                              precise=precise)
    return got, want


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_matches(got, want, rtol):
    np.testing.assert_array_equal(_np(got.series_count), np.asarray(want.series_count))
    for f in ("series_sum", "series_min", "series_max", "series_last"):
        np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=rtol, err_msg=f)
    np.testing.assert_array_equal(_np(got.series_err), np.asarray(want.series_err))
    assert int(got.total_count) == int(want.total_count)
    for f in ("total_sum", "total_min", "total_max"):
        np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)), rtol=rtol,
                                   err_msg=f)


@pytest.mark.parametrize("order,rtol", [("s", 1e-6), ("c", 1e-5), ("sorted", 1e-5)])
def test_scan_matches_jax(order, rtol):
    got, want = _both(_mixed(frac_float=0.4), 1024, order)
    _assert_matches(got, want, rtol)


def test_scan_gauge_fast_tiles_matches_jax():
    """The bench workload: tiled gauges, chunk-major, mostly int-fast tiles."""
    got, want = _both(jsyn.synthetic_streams(32, 97, seed=3), 2048, "c")
    _assert_matches(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["counter", "float"])
def test_scan_single_kind_matches_jax(kind):
    """Tiled counters (int-fast tiles) and floats (float-fast tiles)."""
    got, want = _both(jsyn.synthetic_streams(32, 97, seed=3, kind=kind), 2048, "c")
    _assert_matches(got, want, 1e-5)


def test_scan_precise_matches_jax():
    got, want = _both(_mixed(frac_float=0.4), 1024, "sorted", precise=True)
    _assert_matches(got, want, 1e-5)


def test_stitch_host_errors_matches_jax_and_host_oracle():
    streams = _mixed(seed=31, n_unique=32, frac_annotation=0.2)
    got, want = _both(streams, 64, "sorted")
    assert _np(got.series_err).any(), "annotation streams must err on device"
    stream_for = lambda i: streams[i % len(streams)]
    got_s = tscan.stitch_host_errors(got, stream_for)
    want_s = jscan.stitch_host_errors(want, stream_for)
    assert not np.asarray(got_s.series_err).any()
    _assert_matches(got_s, want_s, 1e-5)
    # and against a full host decode of every series
    per = [np.asarray([dp.value for dp in jdecode(s)], np.float32) for s in streams]
    want_sum = [float(np.sum(per[i % len(per)].astype(np.float64))) for i in range(64)]
    np.testing.assert_allclose(np.asarray(got_s.series_sum, np.float64), want_sum, rtol=1e-5)
    np.testing.assert_array_equal(got_s.series_count, [per[i % len(per)].size for i in range(64)])


def test_scan_rejects_mismatched_shape():
    tp = tfused.pack_lanes(tchunked.build_chunked(jsyn.synthetic_streams(2, 40, seed=1), k=K),
                           device="cpu")
    with pytest.raises(ValueError):
        tscan.chunked_scan_aggregate_packed(tp, s=3, c=1, k=K)
