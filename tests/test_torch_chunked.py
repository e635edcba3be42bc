"""Port parity: m3_tpu_torch.ops.chunked side tables and fused.pack_lanes
against m3_tpu's build_chunked / tile_chunked / pack_lane_inputs."""

import numpy as np
import pytest

from m3_tpu.ops import chunked as jchunked
from m3_tpu.ops import fused as jfused
from m3_tpu.utils import synthetic as jsyn
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import fused as tfused


def _streams(kind, n_unique=24, n_points=97, seed=7):
    if kind == "mixed":
        return jsyn.synthetic_mixed_streams(n_unique, n_points, seed=seed, frac_float=0.4,
                                            frac_tu_change=0.1, frac_annotation=0.1)
    return jsyn.synthetic_streams(n_unique, n_points, seed=seed, kind=kind)


def _fields(batch) -> dict:
    out = {f: getattr(batch, f) for f in jchunked.LANE_FIELDS}
    out.update(fast=batch.fast, fast_float=batch.fast_float, k=batch.k,
               num_series=batch.num_series, num_chunks=batch.num_chunks)
    return out


def _assert_batches_equal(got, want):
    for f in tchunked.LANE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f in tchunked.STATE_PAIR_FIELDS:
            np.testing.assert_array_equal(g[0], w[0], err_msg=f)
            np.testing.assert_array_equal(g[1], w[1], err_msg=f)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)
    np.testing.assert_array_equal(got.fast, want.fast)
    np.testing.assert_array_equal(got.fast_float, want.fast_float)
    assert (got.k, got.num_series, got.num_chunks) == (want.k, want.num_series, want.num_chunks)


@pytest.mark.parametrize("kind", ["gauge", "counter", "float", "mixed"])
@pytest.mark.parametrize("k", [16, 24])
def test_build_chunked_matches(kind, k):
    streams = _streams(kind)
    _assert_batches_equal(tchunked.build_chunked(streams, k=k), jchunked.build_chunked(streams, k=k))


def test_from_numpy_fields_round_trips_jax_batch():
    jb = jchunked.build_chunked(_streams("mixed"), k=16)
    _assert_batches_equal(tchunked.from_numpy_fields(_fields(jb)), jb)


def test_tile_pad_select_match():
    streams = _streams("mixed")
    tb, jb = tchunked.build_chunked(streams, k=16), jchunked.build_chunked(streams, k=16)
    _assert_batches_equal(tchunked.tile_chunked(tb, 61), jchunked.tile_chunked(jb, 61))
    _assert_batches_equal(tchunked.pad_series(tb, 7), jchunked.pad_series(jb, 7))
    sel = [3, 0, 17, 17, 9]
    _assert_batches_equal(tchunked.select_series(tb, sel), jchunked.select_series(jb, sel))
    assert tchunked.window_words(700) == jchunked.window_words(700)


@pytest.mark.parametrize("order", ["c", "s", "sorted"])
@pytest.mark.parametrize("kind", ["gauge", "mixed"])
def test_pack_lanes_matches_pack_lane_inputs(order, kind):
    """Tile flags, lane order, inv and every word of the layout equal the
    reference packer's, with the series tiled on the device side."""
    streams = _streams(kind, n_unique=32)
    n_series = 1000
    jb = jchunked.tile_chunked(jchunked.build_chunked(streams, k=16), n_series)
    want = jfused.pack_lane_inputs(jb, order=order, rows=8)
    got = tfused.pack_lanes(tchunked.build_chunked(streams, k=16), order=order, rows=8,
                            device="cpu", n_series=n_series)
    assert got.n == want.n and got.order == want.order
    np.testing.assert_array_equal(got.tile_flags.numpy(), want.tile_flags)
    if order == "sorted":
        np.testing.assert_array_equal(got.inv, want.inv)
    else:
        assert got.inv is None and want.inv is None
    tiles, cw = want.windows4.shape[:2]
    np.testing.assert_array_equal(
        got.windows.numpy().view(np.uint32),
        want.windows4.transpose(1, 0, 2, 3).reshape(cw, -1),
    )
    np.testing.assert_array_equal(
        got.lanes.numpy().view(np.uint32),
        want.lanes4.transpose(1, 0, 2, 3).reshape(tfused.NLANE, -1),
    )
    if kind == "gauge" and order != "s":
        assert (want.tile_flags == 1).any()  # the fast body is reachable


def test_pack_lanes_rejects_bad_arguments():
    batch = tchunked.build_chunked(jsyn.synthetic_streams(2, 30, seed=1), k=16)
    with pytest.raises(ValueError):
        tfused.pack_lanes(batch, order="x", device="cpu")
    with pytest.raises(ValueError):
        tfused.pack_lanes(batch, rows=12, device="cpu")
