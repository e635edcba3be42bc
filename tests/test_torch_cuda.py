"""The port's CUDA kernels against their plain PyTorch twins, on a card:
the lane-aggregate kernel (B1), the records decode (kernel R), the fused
temporal kernel (B2), the per-field lane-aggregate kernel (B3), and the
resident scan that feeds B1, R and B3 from device residency.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. The file imports torch and the port only, so it runs on
a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from m3_tpu_torch.codec.m3tsz import encode_series
from m3_tpu_torch.ops import chunked, fused
from m3_tpu_torch.utils.synthetic import synthetic_mixed_streams, synthetic_streams
from torch_streams import group_streams

T0 = 1_600_000_000 * 10**9
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 5e-324, 1e-40, -1e-42,
            1e300, -1e300, 3.4e38, 1e-39, -3.0, -1.0, -2.5, 7.0]


def _streams(name):
    if name == "gauge":
        return synthetic_streams(32, 97, seed=13)
    if name == "mixed":
        return synthetic_mixed_streams(64, 97, seed=5, frac_float=0.5)
    return [encode_series([T0 + j * 10**9 for j in range(97)],
                          [0.5] + [SPECIALS[(j * 7 + s) % len(SPECIALS)] for j in range(96)])
            for s in range(16)]


def _assert_records(got, want):
    for f in ("ts", "bits", "point_is_float", "mult", "valid", "err"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _assert_identical(got, want):
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.err, want.err)
    for f in ("sum", "min", "max", "last"):
        x, y = getattr(got, f), getattr(want, f)
        same = (x.view(torch.int32) == y.view(torch.int32)) | (torch.isnan(x) & torch.isnan(y))
        assert bool(same.all()), f


@pytest.mark.cuda
@pytest.mark.parametrize("name,order", [("gauge", "c"), ("mixed", "sorted"), ("specials", "c")])
def test_cuda_kernel_matches_twin(name, order):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    batch = chunked.build_chunked(_streams(name), k=16)
    p = fused.pack_lanes(batch, order=order, rows=8, device="cuda", n_series=4096)
    before = fused.LAUNCHES
    got = fused.lane_aggregates(p.windows, p.lanes, p.tile_flags, n=p.n, k=16)
    assert fused.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = fused.lane_aggregates_reference(p.windows, p.lanes, p.tile_flags, n=p.n, k=16)
    _assert_identical(got, want)


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    win = torch.zeros((6, 1024), dtype=torch.int64, device="cuda")
    lanes = torch.zeros((fused.NLANE, 1024), dtype=torch.int32, device="cuda")
    flags = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        fused.lane_aggregates(win, lanes, flags, n=1024, k=4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gauge", "mixed", "specials"])
def test_cuda_records_kernel_matches_twin(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    batch = chunked.build_chunked(_streams(name), k=16)
    p = fused.pack_lanes(batch, order="s", rows=8, device="cuda", n_series=4096)
    c = batch.num_chunks
    before = chunked.LAUNCHES
    got = chunked.decode_chunked(p.windows, p.lanes, 4096, c, 16)
    assert chunked.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = chunked.decode_chunked_lanes_reference(p.windows, p.lanes, n=p.n, k=16)
    for f in ("ts", "bits", "point_is_float", "mult", "valid"):
        assert torch.equal(getattr(got, f).reshape(p.n, 16), getattr(want, f)), f
    assert torch.equal(got.err, want.err.reshape(4096, c).any(dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 7, 61, 1000])
def test_cuda_temporal_kernel_matches_twin(window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import numpy as np

    from m3_tpu_torch.query.functions import temporal_fused as TF

    rng = np.random.default_rng(3)
    v = rng.normal(100, 10, (512, 720)).astype(np.float32)
    v[rng.random(v.shape) < 0.02] = np.nan
    v[9] = np.nan
    x = torch.from_numpy(v).cuda()
    before = TF.LAUNCHES
    got = TF.fused_temporal(x, window, 10.0, tuple(TF.FUSABLE))
    assert TF.LAUNCHES == before + 1
    want = TF.fused_temporal(x.cpu(), window, 10.0, tuple(TF.FUSABLE))
    for name, g, w in zip(TF.FUSABLE, got, want):
        g = g.cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        ok = ~torch.isnan(w)
        atol = 5e-3 if name.startswith("std") else 1e-4
        assert bool(((g[ok] - w[ok]).abs() <= atol + 1e-4 * w[ok].abs()).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gauge", "mixed", "specials"])
def test_cuda_fields_kernel_matches_twin(name):
    """B3 over the per-field layout, with more lanes than one block and
    windows wide enough to stage through shared memory in several rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel.scan import chunked_device_args

    batch = chunked.tile_chunked(chunked.build_chunked(_streams(name), k=16), 1000)
    args = chunked_device_args(batch, device="cuda")
    before = fused.FIELDS_LAUNCHES
    got = fused.lane_aggregates_fields(**args, k=16)
    assert fused.FIELDS_LAUNCHES == before + 1
    torch.cuda.synchronize()
    _assert_identical(got, fused.lane_aggregates_fields_reference(**args, k=16))


@pytest.mark.cuda
def test_cuda_resident_scan_matches_streamed_and_fused():
    """Decode from residency on the card: the resident scan (device
    assembly + B1) equals the streamed scan bit for bit, the resident
    per-field lanes equal chunked_device_args, and B3 over them counts the
    same datapoints."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.cache.block_cache import BlockKey
    from m3_tpu_torch.ops.chunked import build_chunked
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.resident import (ResidentOptions, ResidentPool, resident_fetch_arrays,
                                       resident_scan_totals, streamed_scan_totals)

    streams = _streams("mixed")
    pool = ResidentPool(ResidentOptions(max_bytes=1 << 22), device="cuda")
    pool.admit_block("ns", 0, T0, 0, [(b"%04d" % i, s, 97) for i, s in enumerate(streams)],
                     chunk_k=16)
    keys = [BlockKey("ns", 0, b"%04d" % i, T0, 0) for i in range(len(streams))]
    got = resident_scan_totals(pool, keys)
    want = streamed_scan_totals(streams, k=16, device="cuda")
    for f in got._fields:
        g, w = getattr(got, f).cpu(), getattr(want, f).cpu()
        if g.is_floating_point():
            assert torch.equal(g.isnan(), w.isnan()), f
            g, w = (torch.where(x.isnan(), 0.0, x).view(torch.int32) for x in (g, w))
        assert torch.equal(g, w), f
    args, s_pad = scan.assemble_resident_lanes(pool.plan_chunked(keys), 64)
    host = scan.chunked_device_args(build_chunked(streams + [b""] * (s_pad - 64), k=16), "cuda")
    assert torch.equal(args["windows"], host["windows"])
    fused_out = scan.chunked_scan_aggregate_fused(args, s_pad, pool.plan_chunked(keys).num_chunks, 16)
    assert int(fused_out.total_count) == int(got.total_count)
    arrays, err = resident_fetch_arrays(pool, keys)
    assert len(arrays) == len(keys) and err.shape == (len(keys),)


@pytest.mark.cuda
def test_cuda_kernel_all_bodies_ragged_lane_count():
    """B1's slab kernel on all three tile bodies at 21,000 lanes, not a
    multiple of its 128-lane slabs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    batch = chunked.build_chunked(synthetic_mixed_streams(64, 97, seed=9, frac_float=0.5), k=16)
    p = fused.pack_lanes(batch, order="sorted", rows=8, device="cuda", n_series=3000)
    assert p.n % 128 and (torch.bincount(p.tile_flags, minlength=3) > 0).all()
    before = fused.LAUNCHES
    got = fused.lane_aggregates(p.windows, p.lanes, p.tile_flags, n=p.n, k=16)
    assert fused.LAUNCHES == before + 1
    torch.cuda.synchronize()
    _assert_identical(got, fused.lane_aggregates_reference(p.windows, p.lanes, p.tile_flags,
                                                           n=p.n, k=16))


def _temporal_input(rows, cols, seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    v = rng.normal(100, 10, (rows, cols)).astype(np.float32)
    v[rng.random(v.shape) < 0.02] = np.nan
    v[min(9, rows - 1)] = np.nan
    return torch.from_numpy(v).cuda()


def _assert_temporal_close(name, got, want):
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want)), name
    ok = ~torch.isnan(want)
    atol = 5e-3 if name.startswith("std") else 1e-4
    assert bool(((got[ok] - want[ok]).abs() <= atol + 1e-4 * want[ok].abs()).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rate", "irate", "increase", "delta", "idelta", "resets",
                                  "changes", "sum_over_time", "count_over_time",
                                  "avg_over_time", "min_over_time", "max_over_time",
                                  "last_over_time", "stddev_over_time", "stdvar_over_time"])
def test_cuda_temporal_single_function_matches_twin(name):
    """B2's one-function specialisations, 515 rows (not a multiple of the
    kernel's 8 rows per CTA), windows 1/7/61/1000."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_fused as TF

    x = _temporal_input(515, 720)
    for window in (1, 7, 61, 1000):
        before = TF.LAUNCHES
        (got,) = TF.fused_temporal(x, window, 10.0, (name,))
        assert TF.LAUNCHES == before + 1
        _assert_temporal_close(name, got, TF.fused_temporal(x.cpu(), window, 10.0, (name,))[0])


@pytest.mark.cuda
@pytest.mark.parametrize("funcs", [("avg_over_time",), ("rate", "stddev_over_time")])
def test_cuda_temporal_long_rows_use_scratch(funcs):
    """Rows too long for shared memory (20,000 columns) keep the kernel's
    arrays in a device scratch buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_fused as TF

    x = _temporal_input(37, 20_000)
    got = TF.fused_temporal(x, 61, 10.0, funcs)
    for name, g, w in zip(funcs, got, TF.fused_temporal(x.cpu(), 61, 10.0, funcs)):
        _assert_temporal_close(name, g, w)


@pytest.mark.cuda
def test_cuda_records_and_fields_on_warp_groups_ragged():
    """R and B3 on lanes whose warps are all int, all float or mixed, with
    time-unit changes and annotations: R on 20,997 lanes gathered into
    arrays of their own as fetch_grid gathers them (Npad neither a multiple
    of 128 nor of 4), B3 on 21,000 per-field lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel.scan import chunked_device_args

    batch = chunked.build_chunked(group_streams(), k=16)
    p = fused.pack_lanes(batch, order="s", rows=8, device="cuda", n_series=3000)
    n = p.n - 3
    win, lanes = p.windows[:, :n].contiguous(), p.lanes[:, :n].contiguous()
    before = chunked.LAUNCHES
    got = chunked.decode_chunked_lanes(win, lanes, n=n, k=16)
    assert chunked.LAUNCHES == before + 1 and n % 128 and n % 4
    torch.cuda.synchronize()
    _assert_records(got, chunked.decode_chunked_lanes_reference(win, lanes, n=n, k=16))
    args = chunked_device_args(chunked.tile_chunked(batch, 3000), device="cuda")
    got = fused.lane_aggregates_fields(**args, k=16)
    torch.cuda.synchronize()
    _assert_identical(got, fused.lane_aggregates_fields_reference(**args, k=16))


def _offset_views(x):
    """x as a view at column 1 of a wider buffer (not contiguous), and as a
    contiguous view 4 bytes past a 16-byte boundary."""
    rows, cols = x.shape
    wide = torch.zeros((rows, cols + 1), dtype=x.dtype, device=x.device)
    wide[:, 1:] = x
    flat = torch.zeros(rows * cols + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view(rows, cols)
    assert shifted.data_ptr() % 16
    return wide[:, 1:], shifted


@pytest.mark.cuda
def test_cuda_kernels_take_offset_views():
    """B1, R and B3 on windows that are offset views of a wider buffer give
    the twin's answer; a contiguous but misaligned input to B1 or R is
    copied into fresh storage once and counted in UNALIGNED_COPIES."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel.scan import chunked_device_args

    batch = chunked.build_chunked(_streams("mixed"), k=16)
    p = fused.pack_lanes(batch, order="s", rows=8, device="cuda", n_series=1024)
    want_b1 = fused.lane_aggregates_reference(p.windows, p.lanes, p.tile_flags, n=p.n, k=16)
    want_r = chunked.decode_chunked_lanes_reference(p.windows, p.lanes, n=p.n, k=16)
    for win, copies in zip(_offset_views(p.windows), (0, 1)):
        before = fused.UNALIGNED_COPIES
        _assert_identical(fused.lane_aggregates(win, p.lanes, p.tile_flags, n=p.n, k=16), want_b1)
        _assert_records(chunked.decode_chunked_lanes(win, p.lanes, n=p.n, k=16), want_r)
        assert fused.UNALIGNED_COPIES == before + 2 * copies
    args = chunked_device_args(chunked.tile_chunked(batch, 1024), device="cuda")
    want_b3 = fused.lane_aggregates_fields_reference(**args, k=16)
    for rows in _offset_views(args["windows"]):
        _assert_identical(fused.lane_aggregates_fields(**dict(args, windows=rows), k=16), want_b3)
