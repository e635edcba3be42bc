"""The port's CUDA kernels against their plain PyTorch twins, on a card:
the lane-aggregate kernel (B1), the records decode (kernel R), the fused
temporal kernel (B2), the per-field lane-aggregate kernel (B3), the
resident scan that feeds B1, R and B3 from device residency, the index
kernels K1 and K2 with the index's device tier, and the grouped
reductions K3.

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
