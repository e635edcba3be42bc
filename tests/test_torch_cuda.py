"""The port's CUDA kernels against their plain PyTorch twins, on a card:
the lane-aggregate kernel (B1), the records decode (kernel R), the fused
temporal kernel (B2), the per-field lane-aggregate kernel (B3), the
resident scan that feeds B1, R and B3 from device residency, the index
kernels K1 and K2 with the index's device tier, the grouped
reductions K3, the step-grid consolidation B-1 with the query plan
over a Database on the card, and the aggregator tier's rollup reductions
B-5a and B-5b with an Aggregator flush on the card, and the write path's
encode B-4 with a device-ingest Database on the card; B1 and R on lanes
that the host codec library prescanned; the whole-stream decode B-6 with
the whole-stream scan and the host-to-device stream.

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
from torch_streams import CONSOLIDATION_CASES, b4_lanes, b7_patterns, group_streams

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
@pytest.mark.parametrize("name", ["gauge", "mixed", "specials"])
def test_cuda_library_prescan_feeds_b1_and_r(name):
    """build_chunked prescans with the host codec library: B1 and R on its
    lanes give the outputs they give on lanes assembled from the Python
    prescan (snapshot_stream)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    streams = _streams(name)
    lib = chunked.build_chunked(streams, k=24)
    plain = chunked.assemble_chunked(streams, [chunked.snapshot_stream(s, 24) for s in streams], 24)
    outs = []
    for batch in (lib, plain):
        p = fused.pack_lanes(batch, order="c", rows=8, device="cuda", n_series=4096)
        agg = fused.lane_aggregates(p.windows, p.lanes, p.tile_flags, n=p.n, k=24)
        q = fused.pack_lanes(batch, order="s", rows=8, device="cuda", n_series=4096)
        rec = chunked.decode_chunked(q.windows, q.lanes, 4096, batch.num_chunks, 24)
        outs.append((agg, rec))
    torch.cuda.synchronize()
    _assert_identical(outs[0][0], outs[1][0])
    _assert_records(outs[0][1], outs[1][1])


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


# ---------------------------------------------------------------------------
# The index kernels K1 (term lookup) and K2 (postings bitmaps), the index's
# device tier on the card, and the grouped reductions K3
# ---------------------------------------------------------------------------


def _key_matrix(n_terms, seed):
    """Sorted distinct terms of 0-10 bytes (NUL extensions among them) in
    four fields, their keys, and query rows over them (present, absent,
    over-width, empty and one-term ranges)."""
    import numpy as np

    from m3_tpu_torch.index.device import kernels as K

    rng = np.random.default_rng(seed)
    raw = {bytes(rng.integers(0, 5, rng.integers(0, 11)).astype(np.uint8) + 96)
           for _ in range(n_terms)}
    raw |= {b"ab", b"ab\x00", b"ab\x00\x00", b""}
    terms = sorted(raw)
    cuts = [0, len(terms) // 5, len(terms) // 2, len(terms) - 1, len(terms)]
    fields = [(a, b - a) for a, b in zip(cuts[:-1], cuts[1:])]
    k = K.key_width_words(max(len(t) for t in terms))
    keys, lens = K.build_term_keys(terms, k)
    values, lo, hi = [], [], []
    for i in range(4 * len(terms) // 3):
        start, count = fields[i % 4]
        r = rng.random()
        values.append(terms[start + int(rng.integers(count))] if r < 0.6 and count else
                      b"a" * (4 * k + 1) if r < 0.7 else
                      bytes(rng.integers(96, 101, rng.integers(0, 9)).astype(np.uint8)))
        a, b = (start, start + count) if rng.random() > 0.1 else (start, start + min(count, 1))
        lo.append(a)
        hi.append(b if rng.random() > 0.05 else a)
    qk, ql = K.build_query_keys(values, k)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))

    return t(keys), t(lens), t(np.asarray(lo, np.int32)), t(np.asarray(hi, np.int32)), t(qk), t(ql)


@pytest.mark.cuda
@pytest.mark.parametrize("n_terms,seed", [(1, 0), (37, 1), (5000, 2), (120000, 3)])
def test_cuda_index_match_terms_matches_twin(n_terms, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.index.device import kernels as K

    args = _key_matrix(n_terms, seed)
    before = K.LAUNCHES["match_terms"]
    got = K.match_terms(*(a.cuda() for a in args))
    assert K.LAUNCHES["match_terms"] == before + 1
    torch.cuda.synchronize()
    want = K.match_terms_reference(*args)
    assert torch.equal(got.cpu(), want)
    assert bool((want >= 0).any())


def _postings(n_terms, n_docs, seed, long_term=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    lists = [np.sort(rng.choice(n_docs, int(rng.integers(0, min(n_docs, 300)) * (rng.random() > 0.1)),
                                replace=False)) for _ in range(n_terms)]
    if long_term:
        lists[n_terms // 2] = np.sort(rng.choice(n_docs, min(long_term, n_docs), replace=False))
    offs = np.cumsum([0] + [len(p) for p in lists])
    post_idx = np.stack([offs[:-1], offs[1:]], axis=1).astype(np.int32)
    data = np.concatenate(lists).astype(np.int32)
    return torch.from_numpy(post_idx), torch.from_numpy(data), offs


def _sorted_terms(n, seed):
    """``n`` distinct sorted terms of 0-9 bytes (NUL extensions among them)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    terms = {b"", b"b", b"b\x00", b"b\x00\x00"}
    while len(terms) < n:
        m = n - len(terms)
        raw = rng.integers(0, 4, (m, 9)).astype(np.uint8) + 96
        terms |= {bytes(r[:l]) for r, l in zip(raw, rng.integers(1, 10, m))}
    return sorted(terms)[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", [1, 2, 32, 33, 34, 1089, 1090, 110_000])
def test_cuda_index_match_terms_key_counts(n_keys):
    """K1's warp search == its twin at every range-length class: whole and
    partial ranges, lo == hi, a query below and above every key, q_len < 0,
    keys padded with zero words to a wider k_max; two runs alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import numpy as np

    from m3_tpu_torch.index.device import kernels as K

    terms = _sorted_terms(n_keys, n_keys)
    k = K.key_width_words(max(len(t) for t in terms)) + 2  # padded to a wider k_max
    rng = np.random.default_rng(n_keys)
    sample = terms if n_keys <= 2000 else [terms[i] for i in rng.integers(0, n_keys, 1500)]
    values = list(sample) + [t + b"a" for t in sample[:300]] + [b"", b"\xff" * 5, b"x" * 4 * k + b"x"]
    lo = np.asarray([rng.integers(0, n_keys + 1) if i % 3 == 0 else 0
                     for i in range(len(values))], np.int32)
    hi = np.asarray([rng.integers(a, n_keys + 1) if i % 3 == 1 else n_keys
                     for i, a in enumerate(lo)], np.int32)
    hi[-2] = lo[-2]  # lo == hi
    keys, lens = K.build_term_keys(terms, k)
    qk, ql = K.build_query_keys(values, k)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))

    args = (t(keys), t(lens), t(lo), t(hi), t(qk), t(ql))
    got = K.match_terms(*(a.cuda() for a in args))
    again = K.match_terms(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    want = K.match_terms_reference(*args)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert bool((want >= 0).any()) and int(want[-1]) == -1


def _span_rows(*rows):
    import numpy as np

    out = [(r, a, b) for r, sp in enumerate(rows) for a, b in sp]
    return np.asarray(out, np.int64).reshape(-1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_docs", [1, 33, 4096, 1_000_003])
def test_cuda_index_bitmaps_match_twin(n_docs):
    """K2's span list == each form's twin word for word, both forms in one
    launch: a term list (-1 gis, duplicates; the longest term has 600,000
    postings at 1M docs; 128 spans, every term twice) and a range, with post_data at every offset from a 16-byte
    boundary; two runs give identical words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import numpy as np

    from m3_tpu_torch.index.device import kernels as K

    n_terms = 64
    post_idx, data, offs = _postings(n_terms, n_docs, n_docs % 97, long_term=600_000)
    n_words = -(-n_docs // 32)
    rng = np.random.default_rng(5)
    for trial in range(8):
        gis = rng.integers(-1, n_terms, rng.integers(0, 20)).astype(np.int32)
        if trial == 0:
            gis = np.asarray([n_terms // 2, -1, n_terms // 2, 3], np.int32)
        if trial == 7:  # every term twice: 128 spans
            gis = np.tile(np.arange(n_terms, dtype=np.int32), 2)
        lo, hi = sorted(rng.integers(0, n_terms + 1, 2).tolist())
        start, end = (int(offs[lo]), int(offs[hi])) if hi > lo else (0, 0)
        spans = _span_rows(K.term_spans(post_idx.numpy(), gis), [(start, end)])
        off = trial % 4  # a view of post_data at every offset from a 16-byte boundary
        pd = torch.cat([torch.zeros(off, dtype=torch.int32), data]).cuda()[off:]
        assert (pd.data_ptr() >> 2) & 3 == off
        before = K.LAUNCHES["bitmap_from_spans"]
        got = K.bitmap_from_spans(pd, spans, 2, n_words)
        again = K.bitmap_from_spans(pd, spans, 2, n_words)
        live = bool((spans[:, 2] > spans[:, 1]).any())  # no posting: no launch
        assert K.LAUNCHES["bitmap_from_spans"] == before + (2 if live else 0)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        want_t = K.bitmap_from_terms_reference(post_idx, data, torch.from_numpy(gis), n_words)
        want_r = K.bitmap_from_term_range_reference(data, start, end, n_words)
        assert torch.equal(got.cpu(), torch.stack([want_t, want_r]))
        assert torch.equal(got.cpu(), K.bitmap_from_spans_reference(data, spans, 2, n_words))
    with pytest.raises(ValueError, match="outside"):  # past the postings: refused, no launch
        K.bitmap_from_spans(data.cuda(), [[0, 0, len(data) + 1]], 2, n_words)


@pytest.mark.cuda
def test_cuda_index_k2_launch_error_raises(monkeypatch):
    """A launch the card refuses (more threads a block than it takes)
    raises out of the wrapper and out of a query through the device
    segment, counted as an error; nothing answers from the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.index.device import DeviceIndexStore, IndexDeviceOptions
    from m3_tpu_torch.index.device import kernels as K
    from m3_tpu_torch.index.ns_index import NamespaceIndex
    from m3_tpu_torch.index.query import term

    post_idx, data, _ = _postings(8, 1000, 1)
    monkeypatch.setattr(K, "_K2_THREADS", 2048)
    spans = _span_rows(K.term_spans(post_idx.numpy(), [1, 2]))
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.bitmap_from_spans(data.cuda(), spans, 1, 32)
    store = DeviceIndexStore(IndexDeviceOptions(max_bytes=1 << 24), device="cuda")
    ix = NamespaceIndex(3600 * 10**9, device_store=store)
    ix.write_batch([(b"s%d" % i, ((b"dc", b"dc%d" % (i % 3)),), T0) for i in range(100)])
    ix.seal_before(T0 + 7200 * 10**9)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ix.query(term(b"dc", b"dc1"), T0 - 1, T0 + 1)
    assert store.stats()["errors"] == 1 and store.stats()["search_hits"] == 0
    torch.cuda.synchronize()  # the refused launch left no fault behind


@pytest.mark.cuda
def test_cuda_launch_floor_runs():
    """The empty kernel of the launch floor launches and leaves no fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.index.device import kernels as K

    before = dict(K.LAUNCHES)
    for _ in range(3):
        K.launch_floor("cuda")
    torch.cuda.synchronize()
    assert K.LAUNCHES == before  # not a kernel of the query path


@pytest.mark.cuda
def test_cuda_index_device_segments_match_host():
    """Two resident index blocks on the card: every query == the host
    executor, through K1 (one batched launch over both segments) and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import numpy as np

    from m3_tpu_torch.index.device import DeviceIndexStore, IndexDeviceOptions
    from m3_tpu_torch.index.device import kernels as K
    from m3_tpu_torch.index.ns_index import NamespaceIndex
    from m3_tpu_torch.index.query import FieldQuery, conj, disj, neg, regexp, term

    hour = 3600 * 10**9
    rng = np.random.default_rng(7)
    store = DeviceIndexStore(IndexDeviceOptions(max_bytes=1 << 26), device="cuda")
    ix = NamespaceIndex(hour, device_store=store)
    for blk, n in ((0, 20000), (1, 3000)):
        ix.write_batch([(b"s%d" % i, ((b"name", b"m_%d" % (i % 50)), (b"host", b"h%d" % i),
                                      (b"dc", b"dc%d" % rng.integers(5))), T0 + blk * hour)
                        for i in range(n)])
    ix.seal_before(T0 + 3 * hour)
    assert store.stats()["admissions"] == 2
    queries = [term(b"name", b"m_7"), regexp(b"host", b"h1.*"), regexp(b"name", b"m_1|m_22"),
               regexp(b"dc", b".*[13]"), conj(regexp(b"name", b"m_.*"), neg(term(b"dc", b"dc2"))),
               disj(term(b"host", b"h5"), FieldQuery(b"dc")), neg(regexp(b"host", b"h2.*")),
               term(b"nope", b"x")]
    for i, q in enumerate(queries):
        before = dict(K.LAUNCHES)
        dev = ix.query(q, T0 - hour, T0 + 3 * hour).docs.ids()
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        host = ix.query(q, T0 - hour, T0 + 3 * hour, force_host=True).docs.ids()
        assert dev == host, q
        # K2: one launch per resident segment and query (none for the last,
        # whose one leaf matches no term); K1: at most one, batched over
        # both segments, for a query with exact leaves
        assert launched["bitmap_from_spans"] == (2 if i < len(queries) - 1 else 0), (q, launched)
        assert launched["match_terms"] <= 1, (q, launched)
    st = store.stats()
    assert st["search_misses"] == 0 and st["errors"] == 0
    assert st["search_hits"] == 2 * len(queries)


def _grouped_input(s, t, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    v = rng.normal(0, 50, (s, t)).astype(np.float32)
    roll = rng.random(v.shape)
    v[roll < 0.1] = 0.0
    v[(roll >= 0.1) & (roll < 0.2)] = -0.0
    v[(roll >= 0.2) & (roll < 0.3)] = np.nan
    v[:, 0] = np.nan
    v[:, 1] = np.where(rng.random(s) < 0.5, 0.0, -0.0)
    return v


def _bits_identical(a, b):
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0.0, a).view(torch.int32),
                            torch.where(b.isnan(), 0.0, b).view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 10, 1000])
def test_cuda_grouped_reduce_matches_twin_and_repeats(groups):
    """K3 == its twin on the CPU bit for bit for all seven ops (+0, -0 and
    NaN in every group; one group of 5,000 members spans several staged
    member lists), and two runs are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.block.core import SeriesMeta
    from m3_tpu_torch.query.functions import aggregation as A

    s, t = 5000, 300
    v = _grouped_input(s, t, groups)
    metas = [SeriesMeta(tags=((b"g", b"%d" % (i % groups)), (b"i", b"%d" % i))) for i in range(s)]
    layout = A.group_by_tags(metas, [b"g"])
    x = torch.from_numpy(v)
    xc = x.cuda()
    for op in A.OPS:
        before = A.LAUNCHES
        got = A.grouped_reduce(xc, layout, op)
        again = A.grouped_reduce(xc, layout, op)
        assert A.LAUNCHES == before + 2
        torch.cuda.synchronize()
        assert _bits_identical(got, again), op
        assert _bits_identical(got.cpu(), A.grouped_reduce(x, layout, op)), op


def _resident_plan_cuda(n_series=300, seed=2, page_words=16, fast=False):
    """A pool on the card with lanes of 1 to 4 chunks (k=8, two chunks a
    side page), float and int series over two blocks, and its plan. Pages
    of 512 (the pool's default), 16 and 6 words put page boundaries at
    different places in the windows. fast: whole chunks, the first half of
    the series int and the rest float, so that tiles get every flag."""
    from m3_tpu_torch.cache.block_cache import BlockKey
    from m3_tpu_torch.codec.m3tsz import Encoder
    from m3_tpu_torch.resident import ResidentOptions, ResidentPool

    rng = np.random.default_rng(seed)
    pool = ResidentPool(ResidentOptions(max_bytes=1 << 22, page_words=page_words,
                                        side_bytes=1 << 22, side_page_chunks=2), device="cuda")
    keys = []
    for i in range(n_series):
        if fast:
            n = 8 * int(rng.integers(2, 5))
            vals = rng.standard_normal(n) * 100
            vals = vals.round(0) if i < n_series // 2 else vals + np.pi
        else:
            n = int(rng.integers(1, 30))
            vals = (rng.standard_normal(n) * 100).round(1 if i % 2 else 0)
        bs = T0 if i % 3 else T0 + 7200 * 10**9
        enc = Encoder(bs)
        t = bs
        for v in vals:
            t += int(rng.integers(1, 20)) * 10**9
            enc.encode(t, float(v))
        sid = b"s%04d" % i
        assert pool.admit_block("ns", i % 2, bs, 0, [(sid, enc.stream(), n)], chunk_k=8).admitted
        keys.append(BlockKey("ns", i % 2, sid, bs, 0))
    return pool.plan_chunked(keys)


def _cuda_slot(plan, route):
    """B-2's slot for a route (the card twin of the CPU tests' _b2_slot)."""
    from m3_tpu_torch.parallel import scan

    if route == "direct":
        return 0
    span = (plan.total_bits.astype(np.int64) + 31) // 32 + plan.window_words
    slot, direct = scan.assembly_slot(plan, int(np.median(span)))
    assert 0 < direct < len(span)
    return slot


@pytest.mark.cuda
@pytest.mark.parametrize("order,rows,s_pad,page_words,route", [
    ("c", 1, 300, 512, "split"), ("s", 1, 300, 512, "split"), ("c", 1, 333, 16, "split"),
    ("s", 2, 333, 6, "split"), ("c", 32, 512, 6, "direct"), ("s", 1, 300, 512, "direct")])
def test_cuda_resident_assembly_routes_match_twin_packed(order, rows, s_pad, page_words, route):
    """Kernel B-2 with its slot forced: one launch taking the staged and
    the direct route (the longer half of the series direct), or every
    series direct; windows, planes and tile flags == the twin bit for bit,
    and the direct series counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan

    plan = _resident_plan_cuda(page_words=page_words)
    slot = _cuda_slot(plan, route)
    before = scan.ASSEMBLY_DIRECT_SERIES
    windows, planes, flags, n = scan._launch_assembly(plan, s_pad, order, False, rows * 128,
                                                      slot=slot)
    assert scan.ASSEMBLY_DIRECT_SERIES - before == scan.assembly_slot(plan, slot)[1] > 0
    want, _ = scan.assemble_resident_packed_reference(plan, s_pad, order=order, rows=rows)
    assert n == want.n
    assert torch.equal(windows, want.windows)
    assert torch.equal(planes, want.lanes)
    assert torch.equal(flags, want.tile_flags)


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,route", [(300, "split"), (512, "direct")])
def test_cuda_resident_assembly_routes_match_twin_fields(s_pad, route):
    """Kernel B-2's per-field layout with its slot forced, == the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan

    plan = _resident_plan_cuda(seed=5)
    windows, planes, _, _ = scan._launch_assembly(plan, s_pad, "s", True, 4096,
                                                  slot=_cuda_slot(plan, route))
    got = scan._lane_fields(windows, planes)
    want, _ = scan.assemble_resident_lanes_reference(plan, s_pad)
    assert set(got) == set(want)
    for f, x in want.items():
        pairs = zip(got[f], x) if isinstance(x, tuple) else [(got[f], x)]
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.cuda
def test_cuda_resident_assembly_tile_flags_every_kind():
    """Tiles of 128 lanes made up by four series blocks each, int-fast,
    float-fast and general: B-2's per-tile AND (atomicAnd from many blocks)
    == the twin's flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan

    plan = _resident_plan_cuda(n_series=256, page_words=512, fast=True)
    for s_pad in (256, 300):
        got, _ = scan.assemble_resident_packed(plan, s_pad, order="c", rows=1)
        want, _ = scan.assemble_resident_packed_reference(plan, s_pad, order="c", rows=1)
        for f in ("windows", "lanes", "tile_flags"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert set(got.tile_flags.tolist()) == {0, 1, 2}


@pytest.mark.cuda
@pytest.mark.parametrize("order,rows,s_pad,page_words", [
    ("c", 1, 300, 16), ("c", 32, 512, 16), ("s", 1, 300, 16), ("s", 2, 333, 16),
    ("c", 1, 300, 6)])
def test_cuda_resident_assembly_matches_twin_packed(order, rows, s_pad, page_words):
    """Kernel B-2 == its twin bit for bit on B1's and R's layout: windows,
    planes and tile flags, with lanes past each series' n_chunks, padding
    series and padding tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan

    plan = _resident_plan_cuda(page_words=page_words)
    assert len(set(plan.n_chunks.tolist())) > 1
    before = scan.ASSEMBLY_LAUNCHES
    got, _ = scan.assemble_resident_packed(plan, s_pad, order=order, rows=rows)
    assert scan.ASSEMBLY_LAUNCHES == before + 1
    want, _ = scan.assemble_resident_packed_reference(plan, s_pad, order=order, rows=rows)
    assert got.n == want.n and got.order == want.order
    for f in ("windows", "lanes", "tile_flags"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad", [300, 512])
def test_cuda_resident_assembly_matches_twin_fields(s_pad):
    """Kernel B-2 == its twin bit for bit on B3's per-field layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan

    plan = _resident_plan_cuda(seed=5)
    got, _ = scan.assemble_resident_lanes(plan, s_pad)
    want, _ = scan.assemble_resident_lanes_reference(plan, s_pad)
    assert set(got) == set(want)
    for f, x in want.items():
        pairs = zip(got[f], x) if isinstance(x, tuple) else [(got[f], x)]
        for a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 1000])
def test_cuda_grouped_reduce_forced_widths_match_twin(groups):
    """K3 at each column-block width (8, 16, 32, forced through the C
    entry) and at the width it picks: [20000, 723] values (T odd: rows
    unaligned, so the ring takes 4-byte copies, and the last column block
    ragged) into one group of 20,000 members, far longer than the ring, or
    1,000 groups of 20. Every op == the twin on the CPU bit for bit, and two
    runs are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.block.core import SeriesMeta
    from m3_tpu_torch.query.functions import aggregation as A

    s, t = 20000, 723
    v = _grouped_input(s, t, 7)
    metas = [SeriesMeta(tags=((b"g", b"%d" % (i % groups)), (b"i", b"%d" % i))) for i in range(s)]
    layout = A.group_by_tags(metas, [b"g"])
    x = torch.from_numpy(v)
    xc = x.cuda()
    pad = torch.from_numpy(np.ascontiguousarray(layout.pad_index, np.int32)).cuda()
    for op in A.OPS:
        want = A.grouped_reduce(x, layout, op)
        for wc in (8, 16, 32, 0):
            got = A.launch_grouped_reduce(xc, pad, op, wc)
            again = A.launch_grouped_reduce(xc, pad, op, wc)
            torch.cuda.synchronize()
            assert _bits_identical(got, again), (op, wc)
            assert _bits_identical(got.cpu(), want), (op, wc)


@pytest.mark.cuda
def test_cuda_launch_errors_name_the_tensors(monkeypatch):
    """A launch the C entry refuses raises out of K3's and B-2's wrappers
    with each launch tensor's shape, stride, dtype and pointer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.query.functions import aggregation as A

    x = torch.zeros((40, 24), device="cuda")
    pad = torch.arange(40, dtype=torch.int32, device="cuda")[None, :]
    with pytest.raises(RuntimeError, match=r"grouped_reduce kernel launch failed: CUDA error "
                       r"\d+; values shape \(40, 24\) stride \(24, 1\) torch.float32 at 0x"):
        A.launch_grouped_reduce(x, pad, "sum", wc=12)  # not a width the kernel has
    plan = _resident_plan_cuda(n_series=40)
    monkeypatch.setattr(scan, "assembly_slot", lambda plan, cap: (cap + 2, 0))  # past the cap
    with pytest.raises(RuntimeError, match=r"resident_assembly kernel launch failed: CUDA error "
                       r"\d+; words shape .* torch.int32 at 0x.*; page_rows shape"):
        scan.assemble_resident_packed(plan, 40)
    torch.cuda.synchronize()  # the refused launches left no fault behind


@pytest.mark.cuda
def test_cuda_grouped_reduce_picks_width_by_shape():
    """The widest column block whose blocks reach the card's SMs, else 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.ops._build import load_library

    lib = load_library("grouped_reduce")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def pick(groups, cols):
        for wc in (32, 16):
            if groups * -(-cols // wc) >= sms:
                return wc
        return 8

    shapes = [(1, 720), (10, 720), (sms, 32), (sms // 2 + 1, 32), (sms // 4 + 1, 32), (1, 11)]
    assert {pick(g, t) for g, t in shapes} == {8, 16, 32}
    for g, t in shapes:
        assert lib.m3_grouped_reduce_width(g, t) == pick(g, t), (g, t)


@pytest.mark.cuda
def test_cuda_grouped_reduce_flushes_subnormals_like_twin():
    """K3 on subnormal, +-0 and NaN inputs (whose sums, means and squared
    deviations are subnormal too) == the twin that flushes them, bit for
    bit, all seven ops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.block.core import SeriesMeta
    from m3_tpu_torch.query.functions import aggregation as A

    rng = np.random.default_rng(12)
    v = (rng.standard_normal((2000, 200)) * 1e-37).astype(np.float32)
    roll = rng.random(v.shape)
    v[roll < 0.2] = np.float32(1e-40)
    v[(roll >= 0.2) & (roll < 0.35)] = np.float32(-3e-40)
    v[(roll >= 0.35) & (roll < 0.45)] = np.nan
    v[(roll >= 0.45) & (roll < 0.55)] = -0.0
    metas = [SeriesMeta(tags=((b"g", b"%d" % (i % 7)), (b"i", b"%d" % i))) for i in range(2000)]
    layout = A.group_by_tags(metas, [b"g"])
    x = torch.from_numpy(v)
    for op in A.OPS:
        got = A.grouped_reduce(x.cuda(), layout, op).cpu()
        want = A.grouped_reduce(x, layout, op)
        assert _bits_identical(got, want), op
        nz = got[(got != 0) & ~got.isnan()]
        assert not (nz.abs() < np.finfo(np.float32).tiny).any(), op


@pytest.mark.cuda
def test_cuda_readmission_device_fault_raises(tmp_path, monkeypatch):
    """A device fault during read-through re-admission (here a real CUDA
    out-of-memory in the pool's upload) is counted and raised out of the
    query: the port does not answer from the streamed result as the
    reference does (ROADMAP §C)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query import m3_storage as m3s
    from m3_tpu_torch.query.promql import Matcher
    from m3_tpu_torch.resident import ResidentOptions
    from m3_tpu_torch.resident import pool as pool_mod
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    db = Database(str(tmp_path), num_shards=2, commitlog_enabled=False,
                  resident_options=ResidentOptions(max_bytes=1 << 22), device="cuda")
    db.create_namespace("ns", NamespaceOptions())
    for i in range(8):
        tags = ((b"__name__", b"g"), (b"s", b"%03d" % i))
        for j in range(40):
            db.write_tagged("ns", tags, T0 + j * 10**10, float(i * j))
    db.flush("ns", T0 + 4 * 3600 * 10**9)
    st = m3s.M3Storage(db, "ns")
    m = [Matcher("__name__", "=", "g")]
    span = (T0, T0 + 3600 * 10**9)
    assert st.scan_totals(m, *span)["path"] == "resident"
    db.resident_clear()
    scatter = pool_mod._scatter

    def oom(buf, idx, staged, inplace):
        torch.empty(1 << 50, dtype=torch.int32, device=buf.device)  # more than the card holds
        return scatter(buf, idx, staged, inplace)

    monkeypatch.setattr(pool_mod, "_scatter", oom)
    before = m3s._M_READMIT_FAILURES.value
    with pytest.raises(torch.OutOfMemoryError):
        st.scan_totals(m, *span)
    assert m3s._M_READMIT_FAILURES.value == before + 1
    monkeypatch.setattr(pool_mod, "_scatter", scatter)
    assert st.scan_totals(m, *span)["path"] == "streamed"  # re-admits this time
    assert st.scan_totals(m, *span)["path"] == "resident"
    db.close()


@pytest.mark.cuda
@pytest.mark.parametrize("s,p", [(64, 1), (300, 2 * 720 + 24), (16, 8193)])
def test_cuda_consolidate_grid_matches_twin(s, p):
    """Kernel B-1 == its twin bit for bit (values with NaN payloads, and
    counts): one record a row, a ragged two-block row, and rows one past
    the kernel's shared-memory tile with grids of more than one pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.ops import decode as D
    from m3_tpu_torch.query import plan as qplan
    from torch_streams import consolidation_records

    rec, grid, lo, hi, lookback = consolidation_records(s, p, seed=p)
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in rec.items()}
    res = D.DecodeResult(err=torch.zeros(s, dtype=torch.bool), **host)
    cuda = D.DecodeResult(*[None if x is None else x.cuda() for x in res])
    before = qplan.LAUNCHES
    got, got_counts = qplan.consolidate_grid(cuda, lo, hi, grid, lookback)
    assert qplan.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want, want_counts = qplan.consolidate_grid_reference(res, lo, hi, grid, lookback)
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
    assert torch.equal(got_counts.cpu(), want_counts)


def _b1_on_card(rec, offset=0):
    """A DecodeResult on the card over seeded numpy records; offset > 0
    places each plane `offset` elements past its storage's start (a
    contiguous view whose rows start off a 16-byte boundary)."""
    from m3_tpu_torch.ops import decode as D

    planes = {}
    for k, v in rec.items():
        x = torch.from_numpy(np.ascontiguousarray(v))
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device="cuda")
        planes[k] = buf[offset:].view(x.shape)
        planes[k].copy_(x)
    return D.DecodeResult(err=torch.zeros(rec["ts"].shape[0], dtype=torch.bool, device="cuda"),
                          **planes)


def _b1_twin(rec, lo, hi, grid, lookback):
    from m3_tpu_torch.ops import decode as D
    from m3_tpu_torch.query import plan as qplan

    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in rec.items()}
    res = D.DecodeResult(err=torch.zeros(rec["ts"].shape[0], dtype=torch.bool), **host)
    return qplan.consolidate_grid_reference(res, lo, hi, grid, lookback)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,run", [(0, 0), (256, 0), (0, 3), (256, 1)])
@pytest.mark.parametrize("case", CONSOLIDATION_CASES)
def test_cuda_consolidate_grid_cases_match_twin(case, tile, run):
    """Kernel B-1 == its twin bit for bit on the adversarial cases
    (torch_streams.consolidation_case), at the kernel's own tile and run
    and forced to tiles of 256 records (several tiles a row, equal
    timestamps across a tile boundary) and to runs of 3 and 1 steps (many
    passes a row, many lanes' runs across each equal run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query import plan as qplan
    from torch_streams import consolidation_case

    rec, grid, lo, hi, lookback = consolidation_case(case, seed=5)
    before = qplan.LAUNCHES
    got, got_counts = qplan.launch_consolidate_grid(_b1_on_card(rec), lo, hi, grid, lookback,
                                                    tile=tile, run=run)
    assert qplan.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want, want_counts = _b1_twin(rec, lo, hi, grid, lookback)
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
    assert torch.equal(got_counts.cpu(), want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("p,t,offset", [(720, 726, 0), (517, 301, 3), (720, 2500, 1)])
def test_cuda_consolidate_grid_rows_past_the_warps(p, t, offset):
    """Kernel B-1 with more rows than the card's resident warps and a row
    count that is not a multiple of the warps a block (each warp walks
    several rows, its next row's copies in flight), == its twin bit for
    bit: at the query's P = 720, T = 726; at a ragged P = 517 with planes
    placed off a 16-byte boundary; at a grid too long for shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query import plan as qplan
    from torch_streams import consolidation_records

    shape = qplan.consolidate_grid_shape(10**6, p, t)
    warps = shape["warps"]
    s = shape["resident_blocks"] * warps * 2 + warps // 2 + 1
    assert qplan.consolidate_grid_shape(s, p, t)["warps"] == warps
    assert s % warps != 0 and shape["registers"] > 0
    assert shape["grid_in_smem"] == (1 if t <= 2048 else 0)
    rec, grid, lo, hi, lookback = consolidation_records(s, p, seed=t)
    grid = np.linspace(grid[0], grid[-1], t).astype(np.int64)
    got, got_counts = qplan.consolidate_grid(_b1_on_card(rec, offset), lo, hi, grid, lookback)
    torch.cuda.synchronize()
    want, want_counts = _b1_twin(rec, lo, hi, grid, lookback)
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
    assert torch.equal(got_counts.cpu(), want_counts)


@pytest.mark.cuda
def test_cuda_consolidate_grid_refuses_bad_arguments():
    """A tile past the kernel's or a run past 24 steps is refused by the
    entry and raised by the wrapper; nothing is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query import plan as qplan
    from torch_streams import consolidation_records

    rec, grid, lo, hi, lookback = consolidation_records(4, 40)
    res = _b1_on_card(rec)
    before = qplan.LAUNCHES
    for tile, run in ((8193, 0), (0, 25)):
        with pytest.raises(RuntimeError, match="consolidate_grid kernel launch failed"):
            qplan.launch_consolidate_grid(res, lo, hi, grid, lookback, tile=tile, run=run)
    assert qplan.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_plan_matches_force_staged(tmp_path):
    """A Database on the card: a range query served by the query plan (B-2,
    R and B-1 launched, no fallback) == the same query force-staged, bit
    for bit; a warm repeat is a plan hit of one ``query_plan`` dispatch,
    beside the ``temporal_fused`` dispatch of B2 where the query has a
    temporal function (as the reference's TPU kernel counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.index.device import IndexDeviceOptions
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.query import plan as qplan
    from m3_tpu_torch.query import stats
    from m3_tpu_torch.query.engine import Engine
    from m3_tpu_torch.query.m3_storage import M3Storage
    from m3_tpu_torch.resident import ResidentOptions
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    db = Database(str(tmp_path), num_shards=2, commitlog_enabled=False,
                  resident_options=ResidentOptions(max_bytes=1 << 24),
                  index_device_options=IndexDeviceOptions(max_bytes=1 << 24), device="cuda")
    db.create_namespace("ns", NamespaceOptions(block_size_nanos=3600 * 10**9))
    rng = np.random.default_rng(4)
    for i in range(40):
        tags = ((b"__name__", b"pm"), (b"job", b"app%d" % (i % 3)), (b"s", b"%03d" % i))
        for j in range(60):
            v = float(j % 9) if i % 3 == 0 else round(float(rng.standard_normal()), 2 + i % 3)
            db.write_tagged("ns", tags, T0 + j * 10**10, v)
    db.flush("ns", T0 + 4 * 3600 * 10**9)
    eng = Engine(M3Storage(db, "ns"), device="cuda")
    span = (T0 + 60 * 10**9, T0 + 560 * 10**9, 20 * 10**9)
    for q, n_b2 in (('rate(pm{job=~"app.*"}[2m])', 1), ('sum by (job) (avg_over_time(pm[1m]))', 1),
                    ('pm{job="app1",s!="004"}', 0)):
        launches = (scan.ASSEMBLY_LAUNCHES, chunked.LAUNCHES, qplan.LAUNCHES)
        st = stats.start(q)
        got = eng.query_range(q, *span)
        stats.finish(st, 0.0)
        assert st.plan_misses == 1 and st.plan_fallbacks == 0, st.to_dict()
        assert (scan.ASSEMBLY_LAUNCHES, chunked.LAUNCHES, qplan.LAUNCHES) == tuple(
            n + 1 for n in launches)
        st = stats.start(q)
        again = eng.query_range(q, *span)
        stats.finish(st, 0.0)
        assert st.plan_hits == 1 and st.device_dispatches == 1 + n_b2
        with qplan.force_staged():
            want = eng.query_range(q, *span)
        assert [m.tags for m in got.metas] == [m.tags for m in want.metas]
        bits = torch.int64 if want.values.dtype == torch.float64 else torch.int32
        for x in (got.values, again.values):
            assert torch.equal(x.cpu().view(bits), want.values.cpu().view(bits))
    db.close()


# --- kernel B-7: deriv, predict_linear, holt_winters, quantile_over_time ---

B7_CALLS = [("deriv", ()), ("predict_linear", (600.0,)), ("holt_winters", (0.3, 0.6)),
            ("holt_winters", (0.9, 0.1))] + [("quantile_over_time", (q,))
                                             for q in (-0.5, 0.0, 0.5, 0.9, 1.0, 1.5)]


def _b7_input(rows, cols, seed=7):
    """Trending rows with 25% NaN, an empty row, a strided row, and a row of
    infinities, signed zeros and repeats."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.normal(1.0, 5.0, (rows, cols)), axis=1).astype(np.float32)
    v[rng.random(v.shape) < 0.25] = np.nan
    v[min(2, rows - 1)] = np.nan
    if rows > 3:
        v[3, ::2] = np.nan
    if rows > 4:
        pool = np.asarray([np.inf, -np.inf, 0.0, -0.0, 1.5, 1.5, np.nan], np.float32)
        v[4] = pool[rng.integers(0, len(pool), cols)]
    return torch.from_numpy(v)


def _assert_b7_bits(got, want, what):
    g, w = got.cpu(), want.cpu()
    same = (g.view(torch.int32) == w.view(torch.int32)) | (torch.isnan(g) & torch.isnan(w))
    assert bool(same.all()), f"{what}: {int((~same).sum())} values differ from the twin"


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 5, 16, 61])
@pytest.mark.parametrize("name,args", B7_CALLS)
def test_cuda_b7_matches_twin(name, args, window):
    """B-7 == its twin bit for bit at the CPU tests' sizes (7 x 60, windows
    up to one longer than the row), through the shared-memory route and the
    device-memory route, at quantile runs of 1, 3, 100 and the kernel's,
    over all columns and over the engine's (first = W - 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_window as TW

    x = _b7_input(7, 60)
    want = TW.temporal_window(name, x, window, 10.0, *args)
    runs = (0, 1, 3, 100) if name == "quantile_over_time" else (0,)
    for first in sorted({0, min(window - 1, 59)}):
        for force_global in (False, True):
            for run in runs:
                before = TW.LAUNCHES
                got = TW.temporal_window(name, x.cuda(), window, 10.0, *args, first=first,
                                         run=run, force_global=force_global)
                assert TW.LAUNCHES == before + 1
                torch.cuda.synchronize()
                _assert_b7_bits(got, want[:, first:],
                                f"{name}{args} w={window} first={first} run={run} "
                                f"global={force_global}")


@pytest.mark.cuda
@pytest.mark.parametrize("name,args", B7_CALLS[:3] + [("quantile_over_time", (0.99,))])
def test_cuda_b7_long_rows_use_device_memory(name, args):
    """Rows too long for shared memory (70,000 columns) are read from device
    memory, the quantile's windows kept in a device scratch buffer; and a
    block of the query's shape, [1,000, 1,080] at W = 361, against the twin
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_window as TW

    x = _b7_input(3, 70_000, seed=9)
    shape = TW.launch_shape(name, 3, 70_000, 31)
    assert shape["staged"] == 0
    got = TW.temporal_window(name, x.cuda(), 31, 10.0, *args)
    _assert_b7_bits(got, TW.temporal_window(name, x, 31, 10.0, *args), f"{name} long rows")
    x = _b7_input(1000, 1080, seed=10).cuda()
    assert TW.launch_shape(name, 1000, 1080, 361)["staged"] == 1
    got = TW.temporal_window(name, x, 361, 10.0, *args)
    _assert_b7_bits(got, TW.FUNCTIONS[name](x, 361, 10.0, *args), f"{name} [1000, 1080] w=361")


@pytest.mark.cuda
def test_cuda_b7_empty_and_error():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_window as TW

    before = TW.LAUNCHES
    assert TW.temporal_window("deriv", torch.zeros((0, 5), device="cuda"), 3, 10.0).shape == (0, 5)
    assert TW.LAUNCHES == before
    with pytest.raises(ValueError):
        TW.temporal_window("deriv", torch.zeros(5, device="cuda"), 3, 10.0)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 3, 31, 61, 200])
@pytest.mark.parametrize("name,args", B7_CALLS)
def test_cuda_b7_validity_patterns(name, args, w):
    """The host-build tests' validity patterns on the card (fold tables,
    the bit walk, interleaved holt_winters recurrences, the one-shift
    slide, NaN without a walk), == the twin sliced at first, bit for bit,
    through both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_window as TW

    names, v = b7_patterns(w)
    x = torch.from_numpy(v)
    want = TW.temporal_window(name, x, w, 10.0, *args)
    cols = v.shape[1]
    runs = (0, 1, 7) if name == "quantile_over_time" else (0,)
    for first in sorted({0, min(w - 1, cols), cols - 1}):
        for force_global in (False, True):
            for run in runs:
                got = TW.temporal_window(name, x.cuda(), w, 10.0, *args, first=first, run=run,
                                         force_global=force_global).cpu()
                for i, row in enumerate(names):
                    _assert_b7_bits(got[i], want[i, first:],
                                    f"{name}{args} w={w} first={first} run={run} "
                                    f"global={force_global} {row}")


@pytest.mark.cuda
@pytest.mark.parametrize("name,args", B7_CALLS[:3] + [("quantile_over_time", (0.9,))])
def test_cuda_b7_long_window(name, args):
    """W = 1,100, beyond the fold tables (every linear window folds sum d
    and sum d^2 with the flags) and the register sort (insertion), staged,
    == the twin on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_window as TW

    x = _b7_input(64, 1300, seed=11).cuda()
    shape = TW.launch_shape(name, 64, 1300, 1100, first=1099)
    assert shape["staged"] == 1 and shape["tables"] == 0
    got = TW.temporal_window(name, x, 1100, 10.0, *args, first=1099)
    _assert_b7_bits(got, TW.FUNCTIONS[name](x, 1100, 10.0, *args)[:, 1099:], f"{name} W=1100")


@pytest.mark.cuda
@pytest.mark.parametrize("run", [0, 23, 90, 360])
def test_cuda_b7_quantile_long_window_layouts(run):
    """quantile_over_time at W = 361 over [1,000, 1,080], first = 360, at
    the kernel's layout (two lanes of 360 columns, two rows a warp: idle
    lanes take no window memory) and at shorter runs (32, 8 and 2 lanes a
    row), on series that start inside the first windows and on full
    windows, == the twin on the card sliced at first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal as T
    from m3_tpu_torch.query.functions import temporal_window as TW

    rng = np.random.default_rng(361)
    v = np.cumsum(rng.normal(0.5, 3.0, (1000, 1080)), axis=1).astype(np.float32)
    v[rng.random(v.shape) < 0.02] = np.nan
    for late in (False, True):
        if late:
            v[:, :360] = np.nan
        x = torch.from_numpy(v).cuda()
        shape = TW.launch_shape("quantile_over_time", 1000, 1080, 361, first=360, run=run)
        assert shape["staged"] == 1
        assert shape["rows_per_warp"] * shape["lanes_per_row"] <= 32
        got = TW.temporal_window("quantile_over_time", x, 361, 10.0, 0.9, first=360, run=run)
        want = T.quantile_over_time(x, 361, 0.9, chunk=32)[:, 360:]
        _assert_b7_bits(got, want, f"W=361 run={run} late={late} {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("name,window,args", [
    ("predict_linear", 361, (14400.0,)), ("deriv", 31, ()), ("holt_winters", 61, (0.3, 0.6)),
    ("quantile_over_time", 31, (0.99,))])
def test_cuda_b7_promql_shapes(name, window, args):
    """[promql]'s four B-7 calls at 1,000 rows: 720 steps behind W - 1 NaN
    columns (the series start inside the first windows), first = W - 1 as
    the engine calls it, staged, == the twin on the card sliced at first;
    and 5% NaN inside the data (windows with gaps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.query.functions import temporal_window as TW

    rng = np.random.default_rng(window)
    v = np.cumsum(rng.normal(0.5, 3.0, (1000, 720 + window - 1)), axis=1).astype(np.float32)
    v[:, :window - 1] = np.nan
    for gaps in (False, True):
        if gaps:
            v[rng.random(v.shape) < 0.05] = np.nan
        x = torch.from_numpy(v).cuda()
        shape = TW.launch_shape(name, *x.shape, window, first=window - 1)
        assert shape["staged"] == 1
        got = TW.temporal_window(name, x, window, 10.0, *args, first=window - 1)
        assert got.shape == (1000, 720)
        want = TW.FUNCTIONS[name](x, window, 10.0, *args)[:, window - 1:]
        _assert_b7_bits(got, want, f"{name} [1000, {x.shape[1]}] w={window} gaps={gaps}")


def _rollup_rows(kind: str, g: int, p: int, seed: int = 9):
    """f32 vals, i32 torder, bool valid [g, p] for B-5a/B-5b: lognormal
    values of both signs, 20% invalid slots, empty rows, and per kind
    signed zeros, subnormals, infinities or NaN in valid slots."""
    rng = np.random.default_rng(seed)
    vals = (rng.lognormal(0, 1, (g, p)) * np.where(rng.random((g, p)) < 0.5, 1, -1)).astype(
        np.float32)
    valid = rng.random((g, p)) < 0.8
    valid[: max(g // 10, 1)] = False
    torder = rng.integers(0, 4, (g, p)).astype(np.int32)  # ties
    roll = rng.random((g, p))
    if kind == "specials":
        for value, lo, hi in ((0.0, 0.0, 0.05), (-0.0, 0.05, 0.1), (1e-40, 0.1, 0.13),
                              (-3e-39, 0.13, 0.15), (1e-20, 0.15, 0.18), (np.inf, 0.18, 0.22),
                              (-np.inf, 0.22, 0.24), (3e38, 0.24, 0.26), (np.nan, 0.26, 0.28)):
            vals[(roll >= lo) & (roll < hi)] = value
    elif kind == "packed":  # a flush's shard widened by one timer: valid prefixes, the last row full
        valid = np.arange(p) < rng.integers(1, 9, g)[:, None]
        valid[-1] = True
    elif kind == "scattered":  # 1 to 40 valid slots anywhere in the row, some NaN
        valid = rng.random((g, p)) < rng.integers(1, 41, g)[:, None] / p
        vals[roll < 0.2] = np.nan
    elif kind == "short33":  # rows of 1 to 8 valid slots, and every 7th row 33 (or all)
        valid = rng.random((g, p)) < 4.5 / p
        for row in valid[::7]:
            row[:] = False
            row[rng.choice(p, min(33, p), replace=False)] = True
    elif kind == "negzero":  # sums that flush to -0 (a + b), then skipped slots or a -0
        a, b = np.float32(-1.5e-38), np.float32(1.4e-38)
        vals = rng.choice(np.array([a, b, -0.0, 1e-39], np.float32), (g, p))
        valid = rng.random((g, p)) < rng.integers(1, 41, g)[:, None] / p
        lo = (-(-p // 32) * 32 - p) // 2
        starts = [max(32 * w - lo, 0) for w in range(-(-p // 32))]  # level-0 windows' first slots
        if 3 <= len(starts) <= 32:  # rows 0 and 1: the last windows' sums a, b and, at the
            # row's last slot, -0; the row's sum -0 (no padding is added behind the last slot).
            # Row 0 holds only those 4 valid slots (a lane's row), row 1 every slot (a warp's)
            vals[:2], valid[0], valid[1] = -0.0, False, True
            for j, x in ((starts[-3], a), (starts[-2], b), (p - 2, a), (p - 1, b)):
                vals[:2, j], valid[0, j] = x, True
    return vals, torder, valid


def _assert_rollup_bits(got, want, what):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape, what
    same = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
    assert bool(same.all()), f"{what}: {int((~same).sum())} values differ"


_ROLLUP_KINDS = ["plain", "specials", "packed", "scattered", "short33", "negzero"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _ROLLUP_KINDS)
@pytest.mark.parametrize("g,p", [(1000, 1), (2003, 3), (100_003, 6), (4001, 8), (2000, 32),
                                 (1000, 33), (257, 1000), (3, 70_000), (62_501, 33), (62_501, 100),
                                 (62_501, 1000)])
def test_cuda_b5a_matches_twin(kind, g, p):
    """B-5a == its twin on the card bit for bit: P = 1 (the reduce XLA
    drops), 3, 6 (config 4) and 8 (the tile route), 32 and 33 (either side of the
    window tree), 1,000 and 70,000 (three window levels); a ragged G; a
    flush's shard widened to 33 / 100 / 1,000 slots. Rows of valid
    prefixes (the packer's layout), of scattered valid slots, of n = 33
    among short rows (a lane a window past 32 valid slots), and of sums
    that flush to -0 (kept at a last window's last slot)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.aggregator import kernels as K

    vals, torder, valid = (torch.from_numpy(a).cuda() for a in _rollup_rows(kind, g, p))
    before = K.LAUNCHES["aggregate_dense"]
    got = K.aggregate_dense_fields(vals, torder, valid)
    assert K.LAUNCHES["aggregate_dense"] == before + 1
    torch.cuda.synchronize()
    _assert_rollup_bits(got, K.aggregate_dense_reference(vals, torder, valid), f"{kind} [{g}, {p}]")
    if kind == "negzero" and 3 <= -(-p // 32) <= 32:
        assert torch.signbit(got[0, :2]).all() and (got[0, :2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _ROLLUP_KINDS)
@pytest.mark.parametrize("g,p", [(1000, 1), (2003, 3), (100_003, 6), (4001, 8), (2000, 17),
                                 (2000, 32), (1000, 33), (257, 1000), (3, 70_000), (62_501, 33),
                                 (62_501, 100), (62_501, 1000)])
def test_cuda_b5b_matches_twin(kind, g, p):
    """B-5b == its twin on the card bit for bit: the tile route (P = 1, 3,
    6, 8), the wide rows' lane and warp routes (at most 8, and at most 32
    valid slots), and the long rows' second launch (more than 32 valid
    slots: a radix select on keys in shared memory, or re-read from device
    memory where a row of 70,000 slots holds more than shared memory
    does); a flush's shard widened to 33 / 100 / 1,000 slots; valid
    prefixes, scattered valid slots (some NaN), and n = 33 among short
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.aggregator import kernels as K

    vals, _, valid = (torch.from_numpy(a).cuda() for a in _rollup_rows(kind, g, p))
    qs = (0.0, 0.1, 0.5, 0.95, 0.99, 0.999, 0.9999, 1.0)
    before = K.LAUNCHES["dense_quantiles"]
    got = K.launch_dense_quantiles(vals, valid, qs)
    assert K.LAUNCHES["dense_quantiles"] == before + 1
    torch.cuda.synchronize()
    _assert_rollup_bits(got, K.dense_quantiles_reference(vals, valid, qs),
                        f"{kind} [{g}, {p}]")


@pytest.mark.cuda
def test_cuda_b5_unaligned_and_strided_views():
    """Inputs at an odd element offset (4-byte, not 16-byte, aligned) and
    strided views (the wrappers copy them contiguous) give the twin's
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.aggregator import kernels as K

    g, p = 4097, 6
    vals, torder, valid = _rollup_rows("specials", g, p)
    flat_v = torch.zeros(g * p + 1, dtype=torch.float32, device="cuda")
    flat_t = torch.zeros(g * p + 1, dtype=torch.int32, device="cuda")
    flat_b = torch.zeros(g * p + 1, dtype=torch.bool, device="cuda")
    flat_v[1:] = torch.from_numpy(vals).flatten().cuda()
    flat_t[1:] = torch.from_numpy(torder).flatten().cuda()
    flat_b[1:] = torch.from_numpy(valid).flatten().cuda()
    v, t, b = flat_v[1:].view(g, p), flat_t[1:].view(g, p), flat_b[1:].view(g, p)
    assert v.data_ptr() % 16 == 4
    want = K.aggregate_dense_reference(v, t, b)
    _assert_rollup_bits(K.aggregate_dense_fields(v, t, b), want, "offset views")
    wide = torch.zeros((g, 2 * p), dtype=torch.float32, device="cuda")
    wide[:, ::2] = v
    _assert_rollup_bits(K.aggregate_dense_fields(wide[:, ::2], t, b), want, "strided vals")
    qs = (0.5, 0.99)
    _assert_rollup_bits(K.dense_quantiles(wide[:, ::2], b, qs),
                        K.dense_quantiles_reference(v, b, qs), "strided quantiles")


@pytest.mark.cuda
def test_cuda_aggregator_flush_matches_cpu():
    """An Aggregator flushing on the card emits what the same one on the
    CPU emits, exactly: counters, gauges and timers (default aggregations
    and quantile overrides) over two policies and several windows; B-5a
    launches once a shard and policy, B-5b where the shard holds a timer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.aggregator import kernels as K
    from m3_tpu_torch.aggregator.aggregator import Aggregator
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import AggregationType, MetricType

    rng = np.random.default_rng(12)
    pols = (StoragePolicy.parse("10s:2d"), StoragePolicy.parse("1m:40d"))
    rows = []
    for _ in range(20_000):
        i = int(rng.integers(0, 2000))
        aggs = (AggregationType.P999, AggregationType.MAX) if i % 31 == 0 else None
        rows.append((f"m{i}".encode(), MetricType(1 + i % 3), T0 + int(rng.integers(0, 120 * 10**9)),
                     float(np.float32(rng.lognormal(0, 2))), pols[: 1 + i % 2], aggs))
    out = []
    for device in ("cuda", "cpu"):
        agg = Aggregator(num_shards=4, device=device)
        agg.add_timed_batch(rows)
        before = dict(K.LAUNCHES)
        out.append([(m.id, m.time_nanos, int(m.agg_type), str(m.policy),
                     np.float64(m.value).tobytes()) for m in agg.flush(T0 + 200 * 10**9)])
        if device == "cuda":
            assert K.LAUNCHES["aggregate_dense"] - before["aggregate_dense"] == 8
            assert K.LAUNCHES["dense_quantiles"] - before["dense_quantiles"] == 8
    assert out[0] == out[1] and len(out[0]) > 10_000


def _b4_lanes(m, n_max, seed):
    """Seeded write-path lanes: ragged counts 1..n_max, int lanes (odd) and
    float lanes (even) over every dod opcode, repeats and long gaps."""
    rng = np.random.default_rng(seed)
    lanes = []
    for i in range(m):
        n = int(rng.integers(1, n_max + 1))
        steps = rng.integers(1, 30, n)
        steps[rng.random(n) < 0.05] = rng.integers(100, 200000)
        t = (T0 + np.cumsum(steps) * 10**9).astype(np.int64)
        if i % 2:
            v = rng.integers(-5000, 5000, n).astype(np.float64)
            v[rng.random(n) < 0.2] = 0.0
            if i % 6 == 1:
                v = np.cumsum(rng.integers(-2, 3, n)).astype(np.float64)
        else:
            v = rng.normal(0, 10, n)
            v[rng.random(n) < 0.2] = np.pi
            v[rng.random(n) < 0.02] = np.nan
        lanes.append((t, v))
    return lanes


# The first design's random batches (ids m-n_max-k-seed), then the edges of
# the warp-a-lane design's steps of 32 records (torch_streams.b4_lanes):
# lanes of 32 and 33 records, single records, a step of repeats, tracker
# falls straddling a step, every dod opcode, k = 5 / 24 / 32 / 64, rows of
# W words not a multiple of 4 (round_words_to 1), M = 1 and M = 17 (not a
# multiple of a block's 16 lanes).
_B4_CASES = [
    pytest.param(("random", m, n_max, seed), k, 512, id=f"{m}-{n_max}-{k}-{seed}")
    for m, n_max, k, seed in [(1, 1, 32, 1), (33, 40, 8, 2), (1000, 200, 32, 3), (517, 300, 5, 4),
                              (4099, 720, 32, 5), (256, 1100, 64, 6), (17, 100, 32, 9)]
] + [
    pytest.param((name,), k, round_to, id=f"{name}-k{k}-w{round_to}")
    for name, k, round_to in [
        ("steps", 32, 512), ("steps", 32, 1), ("single", 32, 512), ("one_lane", 32, 512),
        ("all_int", 32, 512), ("all_float", 32, 512), ("alternating", 32, 512),
        ("alternating", 5, 512), ("alternating", 24, 512), ("alternating", 64, 512),
        ("alternating", 32, 1), ("repeats", 32, 512), ("straddle", 32, 512), ("straddle", 5, 1),
        ("opcodes", 32, 512), ("opcodes", 24, 1)]
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,k,round_to", _B4_CASES)
def test_cuda_b4_encode_matches_twin(case, k, round_to):
    """B-4 == its twin on the card on every output: the words of each row
    (zero past its stream), total_bits, and chunk_offs / chunk_sigs with the
    rows past each lane's last chunk; its C entry into outputs filled with
    -1 gives the same (no word left unwritten); the streams equal the host
    codec."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.ops import encode as E
    from m3_tpu_torch.ops._build import load_library

    lanes = _b4_lanes(*case[1:]) if case[0] == "random" else b4_lanes(case[0])
    kinds = np.asarray([E.classify_lane(t, v, np.ones(len(t))).kind for t, v in lanes], np.int8)
    keep = [i for i in range(len(lanes)) if kinds[i] != E.KIND_NONE]
    lanes, kinds = [lanes[i] for i in keep], kinds[keep]
    inp = E.encode_inputs(lanes, kinds, k=k, round_words_to=round_to, device="cuda")
    T, M = inp.dod.shape
    if round_to == 1:
        assert inp.words % 4 != 0
    before = E.LAUNCHES["encode"]
    got = E.encode_planes(inp)
    torch.cuda.synchronize()
    assert E.LAUNCHES["encode"] == before + 1
    want = E.encode_reference(inp)
    for name, a, b in zip(("words", "total_bits", "chunk_offs", "chunk_sigs"), got, want):
        assert torch.equal(a, b), name
    poisoned = tuple(torch.full_like(x, -1) for x in got)
    rc = load_library("encode").m3_encode_lanes(
        inp.t0.data_ptr(), inp.counts.data_ptr(), inp.float_lane.data_ptr(), inp.dod.data_ptr(),
        inp.vbits.data_ptr(), M, T, k, inp.words, got[2].shape[0],
        *(x.data_ptr() for x in poisoned), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0 and all(torch.equal(a, b) for a, b in zip(poisoned, want))
    res = E.result_of(inp, got, kinds)
    if case[0] == "random":  # rows past a lane's last chunk are reached
        assert (res.n_chunks < res.chunk_offs.shape[0]).any() or res.chunk_offs.shape[0] == 1
    for (t, v), stream in list(zip(lanes, res.streams()))[:128]:
        assert stream == encode_series([int(x) for x in t], [float(x) for x in v])


@pytest.mark.cuda
def test_cuda_database_device_ingest_matches_host_seal(tmp_path):
    """A device-ingest Database on the card writes the filesets of the host
    seal byte for byte and admits its eligible lanes born resident."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import os

    from m3_tpu_torch.ingest import IngestOptions
    from m3_tpu_torch.ops import encode as E
    from m3_tpu_torch.resident import ResidentOptions
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    bsz = 2 * 3600 * 10**9
    bs = T0 // bsz * bsz
    entries = []
    for i, (t, v) in enumerate(_b4_lanes(300, 200, 7)):
        t = bs + (t - t[0]) % (bsz - 10**9) // 10**9 * 10**9
        entries += [(f"s{i}".encode(), int(a), float(b)) for a, b in zip(t, v)]
    files = {}
    for name, ingest in (("host", None), ("dev", IngestOptions())):
        db = Database(str(tmp_path / name), num_shards=4, commitlog_enabled=False,
                      resident_options=ResidentOptions(max_bytes=1 << 26), ingest_options=ingest)
        db.create_namespace("m", NamespaceOptions(block_size_nanos=bsz))
        db.bootstrapped = True
        before = E.LAUNCHES["encode"]
        db.write_batch("m", entries)
        db.flush("m", bs + bsz)
        launched = E.LAUNCHES["encode"] - before
        assert launched == (4 if ingest else 0)
        st = db.resident_pool.stats()
        assert (st["device_admissions"] > 0) == bool(ingest)
        root = str(tmp_path / name)
        files[name] = {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(root) for f in fs}
        db.close()
    assert files["dev"] == files["host"] and files["host"]


# --- the kernel profiler on the card ---


def _profiled(*profilers):
    """Every profiler given at sample_rate 1 until the context ends."""
    import contextlib

    @contextlib.contextmanager
    def run():
        rates = [p.sample_rate for p in profilers]
        try:
            for p in profilers:
                p.sample_rate = 1.0
            yield
        finally:
            for p, r in zip(profilers, rates):
                p.sample_rate = r

    return run()


@pytest.mark.cuda
def test_sampled_b1_and_r_dispatch_wait_on_an_event(monkeypatch):
    """A sampled B1 (``packed_lane_agg``) and R (``chunked_decode``)
    dispatch waits on a CUDA event, never on a device-wide synchronize, and
    the seconds it observes cover the CUDA-event span of its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan

    streams = synthetic_streams(4096, 720, seed=3)
    batch = chunked.build_chunked(streams, k=120)
    pc = fused.pack_lanes(batch, order="c", device="cuda")
    ps = fused.pack_lanes(batch, order="s", device="cuda")
    s, c = len(streams), batch.num_chunks
    for prof, run in ((fused.PROFILER_PACKED, lambda: scan.chunked_scan_aggregate_packed(
            pc, s, c, 120)), (chunked.PROFILER, lambda: scan.chunked_scan_aggregate(ps, s, c, 120))):
        run()  # the key's first sighting: counted as such, not sampled
        torch.cuda.synchronize()
        before = prof._hist.snapshot()
        with _profiled(prof):
            monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronize"))
            for _ in range(5):
                run()
            monkeypatch.undo()
        counts, total, n = prof._hist.snapshot()
        assert n == before[2] + 5
        samples = list(prof.device_samples)[-5:]
        assert len(samples) == 5
        for seconds, device_ms in samples:
            assert device_ms > 0 and seconds * 1e3 >= device_ms, (prof.kernel, seconds, device_ms)
        assert total - before[1] == pytest.approx(sum(sec for sec, _ in samples))


@pytest.mark.cuda
def test_warm_plan_dispatches_with_profilers_sampling(tmp_path):
    """With every profiler sampling, a warm plan-served query still makes one
    ``query_plan`` dispatch (plus B2's own for a temporal function), and a
    sampled dispatch's seconds reach the tenant ledger."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.index.device import IndexDeviceOptions
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.query import plan as qplan
    from m3_tpu_torch.query import stats, tenants
    from m3_tpu_torch.query.engine import Engine
    from m3_tpu_torch.query.functions import temporal_fused as TF
    from m3_tpu_torch.query.m3_storage import M3Storage
    from m3_tpu_torch.resident import ResidentOptions
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    db = Database(str(tmp_path), num_shards=2, commitlog_enabled=False,
                  resident_options=ResidentOptions(max_bytes=1 << 24),
                  index_device_options=IndexDeviceOptions(max_bytes=1 << 24), device="cuda")
    db.create_namespace("ns", NamespaceOptions(block_size_nanos=3600 * 10**9))
    for i in range(40):
        tags = ((b"__name__", b"pm"), (b"job", b"app%d" % (i % 3)), (b"s", b"%03d" % i))
        for j in range(60):
            db.write_tagged("ns", tags, T0 + j * 10**10, float((i + j) % 11))
    db.flush("ns", T0 + 4 * 3600 * 10**9)
    eng = Engine(M3Storage(db, "ns"), device="cuda")
    span = (T0 + 60 * 10**9, T0 + 560 * 10**9, 20 * 10**9)
    profs = (qplan.PROF, TF._JIT, IK.PROFILER, fused.PROFILER_PACKED, chunked.PROFILER,
             scan.RESIDENT_CHUNKED_PROF)
    led = tenants.TenantLedger(max_tenants=8)
    old, tenants.LEDGER = tenants.LEDGER, led
    try:
        with _profiled(*profs):
            for q, n_b2 in (('rate(pm{job=~"app.*"}[2m])', 1), ('pm{job="app1",s!="004"}', 0)):
                eng.query_range(q, *span)  # builds the plan
                eng.query_range(q, *span)  # every key seen once
                st = stats.start(q)
                with tenants.tenant_context("card"):
                    eng.query_range(q, *span)
                stats.finish(st, 0.0)
                assert st.plan_hits == 1 and st.device_dispatches == 1 + n_b2, st.to_dict()
        assert led.window_totals("card")["decode_seconds"] > 0
    finally:
        tenants.LEDGER = old
        db.close()


@pytest.mark.cuda
def test_collect_device_memory_on_the_card(tmp_path):
    """The device-memory split of a Database on the card: the resident pool
    and the index tier as their owners count them, the live total
    (torch.cuda.memory_allocated) at least their sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.index.device import IndexDeviceOptions
    from m3_tpu_torch.profiling import collect_device_memory
    from m3_tpu_torch.resident import ResidentOptions
    from m3_tpu_torch.storage.database import Database, NamespaceOptions

    db = Database(str(tmp_path), num_shards=2, commitlog_enabled=False,
                  resident_options=ResidentOptions(max_bytes=1 << 24),
                  index_device_options=IndexDeviceOptions(max_bytes=1 << 24), device="cuda")
    db.create_namespace("ns", NamespaceOptions(block_size_nanos=3600 * 10**9))
    for i in range(40):
        tags = ((b"__name__", b"mem"), (b"s", b"%03d" % i))
        for j in range(60):
            db.write_tagged("ns", tags, T0 + j * 10**10, float(j))
    db.flush("ns", T0 + 4 * 3600 * 10**9)
    out = collect_device_memory(db)
    assert out["resident_pool"] == db.resident_pool.device_bytes() > 0
    assert out["index"] == db.index_device_store.device_bytes() > 0
    assert out["total_live_jax_bytes"] >= out["resident_pool"] + out["index"]
    assert out["total_live_jax_bytes"] == torch.cuda.memory_allocated(db.resident_pool.device)
    assert out["other"] == out["total_live_jax_bytes"] - out["resident_pool"] - out["index"]
    db.close()


def _b6_streams(name):
    """The streams of one of B-6's edge cases (see B6_CASES) and the unit
    their decode starts from."""
    from m3_tpu_torch.codec.m3tsz import Encoder
    from m3_tpu_torch.utils.xtime import Unit

    rng = np.random.default_rng(23)
    t = [T0 + (j + 1) * 10**9 for j in range(97)]
    ints = lambda i: [float(v) for v in rng.integers(-5000, 5000, 97) / 10 ** (i % 7)]
    floats = lambda: [float(v) for v in rng.normal(0, 1e3, 97)]
    if name == "ends_early":
        # a warp's series end at records 1 .. 97 (EOS), int and float ones
        return [encode_series(t[:n], (ints(i) if i % 2 else floats())[:n])
                for i, n in enumerate(1 + (np.arange(64) * 37) % 97)], Unit.SECOND
    if name == "all_int":
        return [encode_series(t, ints(i)) for i in range(64)], Unit.SECOND
    if name == "all_float":
        return [encode_series(t, floats()) for _ in range(64)], Unit.SECOND
    if name == "mixed_warps":
        return [encode_series(t, ints(i) if i % 2 else floats()) for i in range(64)], Unit.SECOND
    if name == "long_annotation":
        # a 300-byte annotation after 5 points: longer than a series' ring;
        # the reference ends that series there with err
        enc = Encoder(T0)
        for j in range(97):
            enc.encode(t[j], float(j % 9), annotation=bytes(range(256)) + b"x" * 44 if j == 5
                       else None)
        return [enc.stream()] + group_streams()[:40], Unit.SECOND
    if name == "wide_records":
        # 64-bit nanosecond dods and random floats, ~130 bits a record: runs
        # of records past what a ring holds ahead, read from the row
        out = []
        for _ in range(40):
            enc = Encoder(T0, default_unit=Unit.NANOSECOND)
            ts = T0
            for v in rng.normal(0, 1e6, 97):
                ts += int(rng.integers(1, 2**40))
                enc.encode(ts, float(v), unit=Unit.NANOSECOND)
            out.append(enc.stream())
        return out, Unit.NANOSECOND
    if name == "tu_at_flush":
        # time-unit markers either side of each flush of 16 records and of
        # the u8 planes' 32 (15, 16, 31, 32, 63, 64, 95, 96)
        out = []
        for k in range(33):
            enc = Encoder(T0)
            unit = Unit.SECOND
            for j in range(97):
                if j in (15, 16, 31, 32, 63, 64, 95, 96) or j == k + 40:
                    unit = Unit.MILLISECOND if unit == Unit.SECOND else Unit.SECOND
                enc.encode(t[j], float(j % 11), unit=unit)
            out.append(enc.stream())
        return out, Unit.SECOND
    raise KeyError(name)


def _b6_inputs(name):
    """(BatchedSegments, T, initial unit) of one B-6 case: the parity kinds,
    the warp mixes, rows cut to 9 words (every fetch past the cut repeats
    word 8), run lengths around the flushes (every 16 records; the u8
    planes every 32), series counts that leave a partial warp or block, and
    the edge cases of _b6_streams."""
    from m3_tpu_torch.segment.batched import BatchedSegments
    from m3_tpu_torch.utils.xtime import Unit

    t = B6_CASES[name]
    unit = Unit.SECOND
    if name in ("gauge", "mixed", "specials"):
        streams = _streams(name)
    elif name in ("groups", "cut") or name.startswith("len"):
        streams = group_streams()
    elif name.startswith("series"):
        base = group_streams()
        streams = [base[i % len(base)] for i in range(int(name[6:]))]
    else:
        streams, unit = _b6_streams(name)
    seg = BatchedSegments.from_streams(streams)
    if name == "cut":
        seg = BatchedSegments(words=np.ascontiguousarray(seg.words[:, :9]),
                              num_bits=seg.num_bits)
    return seg, t, unit


# name -> T (records decoded a series)
B6_CASES = {"gauge": 120, "mixed": 120, "specials": 120, "groups": 120, "cut": 120,
            "len1": 1, "len15": 15, "len16": 16, "len17": 17, "len31": 31, "len32": 32,
            "len33": 33, "len121": 121, "series1": 120, "series33": 120, "series161": 120,
            "ends_early": 120,
            "long_annotation": 120, "wide_records": 120, "tu_at_flush": 120, "all_int": 120,
            "all_float": 120, "mixed_warps": 120}


@pytest.mark.cuda
@pytest.mark.parametrize("int_optimized", [True, False])
@pytest.mark.parametrize("name", list(B6_CASES))
def test_cuda_b6_matches_twin(name, int_optimized):
    """Kernel B-6 == its twin on a CPU copy of the inputs, every field bit
    for bit (values_f32 by its bits: the kernel stores every NaN as the
    CPU's 0x7FC00000), and == the twin run on the card but for NaN bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.ops import decode

    seg, t, unit = _b6_inputs(name)
    words, nb, _ = decode.batched_device_args(seg, device="cuda")
    iu = torch.from_numpy(seg.initial_units(unit).astype(np.int32)).cuda()
    args = (words, nb, iu)
    before = decode.LAUNCHES
    got = decode.decode_batched(*args, t, int_optimized=int_optimized)
    assert decode.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = decode.decode_batched(*(x.cpu() for x in args), t, int_optimized=int_optimized)
    for f in ("ts", "bits", "point_is_float", "mult", "valid", "err"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert torch.equal(got.values_f32.cpu().view(torch.int32), want.values_f32.view(torch.int32))
    on_card = decode.decode_batched_reference(*args, t, int_optimized=int_optimized)
    x, y = got.values_f32, on_card.values_f32
    assert bool(((x.view(torch.int32) == y.view(torch.int32)) | (x.isnan() & y.isnan())).all())
    if name == "groups" and int_optimized:
        assert bool(got.err.any()) and bool(got.valid.any())
    if name == "long_annotation" and int_optimized:
        assert bool(got.err[0]) and int(got.valid[0].sum()) == 5
    if name == "ends_early" and int_optimized:
        counts = got.valid.sum(1).cpu()
        assert int(counts.min()) == 1 and int(counts.max()) == 96


@pytest.mark.cuda
def test_cuda_scan_aggregate_matches_chunked_scan():
    """The whole-stream scan (B-6) and the chunked scan (R) of the same
    720-point streams: the same f32 values in the same row positions, so
    equal per-series counts, extremes and last values, and sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.ops import decode
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.segment.batched import BatchedSegments

    streams = synthetic_streams(64, 720, seed=3)
    n = 4096
    seg = BatchedSegments.from_streams([streams[i % 64] for i in range(n)])
    got = scan.scan_aggregate(*decode.batched_device_args(seg, device="cuda"), 720)
    batch = chunked.build_chunked(streams, k=24)
    packed = fused.pack_lanes(batch, order="s", device="cuda", n_series=n)
    want = scan.chunked_scan_aggregate(packed, n, batch.num_chunks, 24)
    for f in ("series_count", "series_min", "series_max", "series_last", "series_sum"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.total_count) == int(want.total_count) == n * 720


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [0, 2])
def test_cuda_stream_aggregate_matches_batches(prefetch):
    """The stream on the card (pinned uploads on a side stream) == the fold
    of each batch's packed scan, bit for bit. Every batch holds other
    streams (a seed each), so a kernel that read a buffer before its upload
    finished, or another batch's, would change the totals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from m3_tpu_torch.parallel import scan, stream

    batches = [chunked.tile_chunked(chunked.build_chunked(
        synthetic_mixed_streams(64, 97, seed=5 + i, frac_float=0.3), k=16), 2048)
        for i in range(5)]
    drains = []
    got = stream.stream_aggregate(stream.packed_batches(batches), prefetch=prefetch,
                                  drain_times=drains, device="cuda")
    totals = stream.StreamTotals()
    sums = set()
    for b in batches:
        out = scan.chunked_scan_aggregate_packed(
            fused.pack_lanes(b, device="cuda"), s=b.num_series, c=b.num_chunks, k=16)
        sums.add(float(out.total_sum))
        totals.fold(out)
    assert len(sums) == len(batches), "the batches must differ"
    assert got.finalize() == totals.finalize() and len(drains) == 5
