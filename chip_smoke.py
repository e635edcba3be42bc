"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  build    — compile the kernel libraries from their csrc/ sources with
             nvcc, one process per source, all started together.
  parity   — lane-aggregate kernels B1 (packed layout) and B3 (per-field
             layout, series-major) vs their plain PyTorch twins, per lane,
             on gauge, counter, float, mixed and special-value batches
             (4,096 series x 720 points, k=24): count and err exact,
             sum/min/max/last bit-identical with NaN in the same places.
  main     — the scan-and-aggregate path at 1,048,576 series x 720 points,
             k=24, 64 unique gauge streams, seed 3: synthetic_streams ->
             build_chunked -> pack_lanes (tiled on the card) ->
             chunked_scan_aggregate_packed. total_count must equal the host
             decode exactly, total_sum within rtol 1e-3. Then the kernel's
             warm time (CUDA events), the end-to-end rate, the twin's time
             and a per-lane kernel-vs-twin check at this shape.
  records  — records decode (kernel R) vs its twin on the same five batch
             kinds, series-major: timestamps, value bits, point_is_float,
             mult, valid and err exactly equal.
  temporal — fused temporal kernel (B2) vs its twin, all 15 functions in one
             launch, on f32 [4096, 720] with 2% NaN and one all-NaN row,
             seed 3, windows 1, 7, 61 and 1000: NaN pattern identical,
             values within 1e-4 abs + 1e-4 rel (5e-3 abs for stddev/stdvar).
             Then B2's one-function kernels on f32 [100000, 726] (2% NaN,
             seed 4): each of the 15 alone at w=7, and avg_over_time and
             rate at windows 1/7/61/1000, each held to the same bounds
             against its twin and timed beside the bytes bound and
             F.avg_pool1d at the same window.
  resident — decode from device residency at BASELINE config 2 scale
             (RESIDENT_SERIES = 1,048,576 series x 720 points, k=24, the 64
             unique gauge streams of seed 3): 16 admit_block calls of 65,536
             series (one volume each, side snapshots computed once per
             unique stream) into a ResidentPool of 3 GiB pages + 2 GiB side
             planes on the card. Checks: (1) assemble_resident_packed ==
             pack_lanes of the same streams on windows, lanes and
             tile_flags exactly; (2) resident_scan_totals (B1) bit-identical
             to chunked_scan_aggregate_packed on those lanes; (3) warm
             scans move zero upload bytes; (4) B3
             (chunked_scan_aggregate_fused over assemble_resident_lanes) ==
             its twin per lane, total_count equal to (2)'s; (5)
             resident_fetch_arrays (R) on the first 100,000 keys equals the
             host decode bit for bit. Then the admission's host seconds,
             upload bytes and occupancy, the assembly time, B3's time,
             launches and bound, its twin's time, the warm resident scan
             end to end beside [main]'s, and the peak device memory.
  query    — the range-query path at BASELINE config 3: a block of 100,000
             series x 720 points at 10 s (64 unique gauge streams, seed 3,
             tiled on the card), tags __name__=m3_scan, job=job-{i % 10},
             host=h{i}; Engine(BlockStorage).query_range of
             sum by (job) (rate(m3_scan[1m])) and
             avg by (job) (avg_over_time(m3_scan[1m])) at a 10 s step
             (window 7). The grid of the unique rows must equal the host
             decode + consolidate_row bit for bit, and each job's result the
             f64 sum of the unique rows' twin outputs weighted by their
             multiplicity, within rtol 1e-4. Then each stage's time (CUDA
             events), the end-to-end query_range median of 10 (host clock,
             ending in a host copy), each kernel's bound, B2's library
             yardstick and the peak device memory.
Prints the card as nvidia-smi reports it, a {"kernels": [...]} line, and
as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PARITY_SERIES, MAIN_SERIES, N_POINTS, K, N_UNIQUE = 4096, 1 << 20, 720, 24, 64
QUERY_SERIES, QUERY_JOBS, STEP = 100_000, 10, 10 * 10**9
RESIDENT_SERIES, RESIDENT_CALLS, FETCH_KEYS = 1 << 20, 16, 100_000
T0 = 1_600_000_000 * 10**9
KINDS = [("gauge", "c", 32), ("counter", "c", 32), ("float", "c", 32), ("mixed", "sorted", 8),
         ("specials", "c", 32)]
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 5e-324, 1e-40, -1e-42,
            1e300, -1e300, 3.4e38, 1e-39, -3.0, -1.0, -2.5, 7.0]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> list[float]:
    import torch

    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def occupancy(kernel: str, cw: int) -> str:
    """A lane kernel's registers a thread (of the loaded kernel) and its
    blocks per SM at windows of cw words (the runtime's occupancy query, as
    the launch sizes its grid)."""
    import ctypes

    import torch

    from m3_tpu_torch.ops import _build, fused
    from m3_tpu_torch.ops.decode import barrel_mask

    cap, regs = ctypes.c_int64(0), ctypes.c_int(0)
    rc = _build.load_library("lane_aggregates").m3_lane_resident_blocks(
        fused.LANE_KERNELS[kernel], cw, barrel_mask(cw), ctypes.byref(cap), ctypes.byref(regs))
    if rc != 0:
        raise RuntimeError(f"occupancy query for {kernel} failed: CUDA error {rc}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return f"{regs.value} registers, {cap.value / sms:g} blocks of 128 threads per SM"


def check_no_unaligned_copies(path: str) -> None:
    """The kernels' inputs on every path are 16-byte aligned: no wrapper
    copied one (fused.UNALIGNED_COPIES stays 0)."""
    from m3_tpu_torch.ops import fused

    log(f"[{path}] UNALIGNED_COPIES {fused.UNALIGNED_COPIES}")
    if fused.UNALIGNED_COPIES:
        raise AssertionError(f"{path}: a kernel input was copied to align it")


def compare_lanes(got, want) -> float:
    """Per-lane kernel vs twin: count/err exact, floats bit-identical with
    NaN in the same places. Returns the largest absolute difference."""
    import torch

    if not torch.equal(got.count, want.count):
        raise AssertionError("count differs between kernel and twin")
    if not torch.equal(got.err, want.err):
        raise AssertionError("err differs between kernel and twin")
    worst = 0.0
    for name in ("sum", "min", "max", "last"):
        x, y = getattr(got, name), getattr(want, name)
        both_nan = torch.isnan(x) & torch.isnan(y)
        same = (x.view(torch.int32) == y.view(torch.int32)) | both_nan
        if not bool(same.all()):
            bad = torch.nonzero(~same)[:5, 0].tolist()
            raise AssertionError(
                f"{name} differs at lanes {bad}: kernel {x[bad].tolist()} twin {y[bad].tolist()}"
            )
        finite = torch.isfinite(x) & torch.isfinite(y)
        if bool(finite.any()):
            worst = max(worst, float((x[finite] - y[finite]).abs().max()))
    return worst


def chunk_words(streams, cw: int, c: int, k: int) -> np.ndarray:
    """int64[S, C]: the window words each chunk-lane's bits occupy (at most
    CW; 0 for an empty lane)."""
    from m3_tpu_torch.ops.chunked import snapshot_stream

    words = np.zeros((len(streams), c), np.int64)
    for si, data in enumerate(streams):
        for ci, p in enumerate(snapshot_stream(data, k)):
            if p["span"] > 0:
                words[si, ci] = min(cw, -(-((p["off"] & 31) + p["span"]) // 32))
    return words


def needed_bytes(streams, packed, n_series: int, k: int) -> dict:
    """Bytes the main path's lane function must move, each read or write
    once: for every real lane the window words its chunk's bits occupy,
    the state planes its tile's body reads (general 17, int-fast 5,
    float-fast 6), the tile flags, and 21 bytes of aggregates written.
    Chunk-major lanes (order "c"), series i tiling unique series i % S."""
    import torch

    cw, npad = packed.windows.shape
    s_u = len(streams)
    c = packed.n // n_series
    words_u = chunk_words(streams, cw, c, k)
    dev = packed.windows.device
    lane = torch.arange(packed.n, device=dev)
    words = torch.from_numpy(words_u).to(dev)[(lane % n_series) % s_u, lane // n_series]
    tile_lanes = npad // packed.tile_flags.numel()
    planes = torch.tensor([17, 5, 6], device=dev)[packed.tile_flags[lane // tile_lanes]]
    parts = {
        "windows": int(words.sum()) * 4,
        "planes": int(planes.sum()) * 4,
        "tile_flags": packed.tile_flags.numel() * 4,
        "outputs": packed.n * (4 * 4 + 4 + 1),
    }
    parts["total"] = sum(parts.values())
    return parts


def phase_streams(kind: str) -> list[bytes]:
    """The unique streams of one batch kind of the parity and records
    phases. mixed: float, counter, time-unit-change and annotated series;
    specials: NaN, infinities, signed zeros and subnormals (FTZ, NaN-aware
    min/max) after a first value of 0.5."""
    from m3_tpu_torch.codec.m3tsz import encode_series
    from m3_tpu_torch.utils.synthetic import synthetic_mixed_streams, synthetic_streams

    if kind == "mixed":
        return synthetic_mixed_streams(N_UNIQUE, N_POINTS, seed=5, frac_float=0.5)
    if kind == "specials":
        return [encode_series(
            [T0 + j * 10**9 for j in range(N_POINTS)],
            [0.5] + [SPECIALS[(j * 7 + i) % len(SPECIALS)] for j in range(N_POINTS - 1)],
        ) for i in range(16)]
    return synthetic_streams(N_UNIQUE, N_POINTS, seed=3, kind=kind)


def phase_parity(dev) -> float:
    import torch

    from m3_tpu_torch.ops import fused
    from m3_tpu_torch.ops.chunked import build_chunked

    worst = 0.0
    # mixed: sorted series and 8-row tiles, so all three bodies get tiles
    for kind, order, rows in KINDS:
        batch = build_chunked(phase_streams(kind), k=K)
        p = fused.pack_lanes(batch, order=order, rows=rows, device=dev, n_series=PARITY_SERIES)
        got = fused.lane_aggregates(p.windows, p.lanes, p.tile_flags, n=p.n, k=K)
        torch.cuda.synchronize()
        want = fused.lane_aggregates_reference(p.windows, p.lanes, p.tile_flags, n=p.n, k=K)
        err = compare_lanes(got, want)
        worst = max(worst, err)
        flags = torch.bincount(p.tile_flags, minlength=3).tolist()
        log(f"[parity] {kind:8s} order={order} rows={rows} lanes={p.n} cw={p.windows.shape[0]} "
            f"tiles(general,int,float)={flags} err_lanes={int(want.err.sum())} "
            f"max_abs_err={err!r}")
    return worst


def phase_parity_fields(dev) -> float:
    """B3 vs its twin per lane on the five batch kinds, series-major
    per-field lanes of the 4,096-series batches."""
    import torch

    from m3_tpu_torch.ops import fused
    from m3_tpu_torch.ops.chunked import build_chunked, tile_chunked
    from m3_tpu_torch.parallel.scan import chunked_device_args

    worst = 0.0
    for kind, _, _ in KINDS:
        batch = tile_chunked(build_chunked(phase_streams(kind), k=K), PARITY_SERIES)
        args = chunked_device_args(batch, device=dev)
        got = fused.lane_aggregates_fields(**args, k=K)
        torch.cuda.synchronize()
        want = fused.lane_aggregates_fields_reference(**args, k=K)
        err = compare_lanes(got, want)
        worst = max(worst, err)
        log(f"[parity] B3 {kind:8s} lanes={batch.windows.shape[0]} cw={batch.windows.shape[1]} "
            f"err_lanes={int(want.err.sum())} max_abs_err={err!r}")
    check_no_unaligned_copies("parity")
    return worst


def phase_main(dev, worst: float):
    import torch

    from m3_tpu_torch.codec.m3tsz import decode
    from m3_tpu_torch.ops import fused
    from m3_tpu_torch.ops.chunked import build_chunked
    from m3_tpu_torch.parallel.scan import chunked_scan_aggregate_packed
    from m3_tpu_torch.utils.synthetic import synthetic_streams

    t0 = time.perf_counter()
    streams = synthetic_streams(N_UNIQUE, N_POINTS, seed=3)
    batch = build_chunked(streams, k=K)
    host_s = time.perf_counter() - t0
    packed = fused.pack_lanes(batch, order="c", device=dev, n_series=MAIN_SERIES)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0 - host_s
    s, c = MAIN_SERIES, batch.num_chunks
    cw = packed.windows.shape[0]

    fused.LAUNCHES = 0
    t0 = time.perf_counter()
    out = chunked_scan_aggregate_packed(packed, s=s, c=c, k=K)
    total_count = int(out.total_count)
    first_call_s = time.perf_counter() - t0
    launches = fused.LAUNCHES
    if launches < 1:
        raise AssertionError("main path did not launch the lane_aggregates kernel")

    reps = MAIN_SERIES // N_UNIQUE
    per = [decode(x) for x in streams]
    want_count = reps * sum(len(d) for d in per)
    want_sum = reps * sum(float(np.sum(np.asarray([dp.value for dp in d], np.float32),
                                       dtype=np.float64)) for d in per)
    got_sum = float(out.total_sum)
    if total_count != want_count:
        raise AssertionError(f"total_count {total_count} != host decode {want_count}")
    if not abs(got_sum - want_sum) <= 1e-3 * abs(want_sum):
        raise AssertionError(f"total_sum {got_sum} vs host {want_sum}: beyond rtol 1e-3")
    if not (np.isfinite(got_sum) and out.series_sum.shape == (s,)
            and bool(torch.isfinite(out.series_sum).all())):
        raise AssertionError("non-finite or misshapen series sums")
    log(f"[main] {s} series x {N_POINTS} pts k={K}: lanes={packed.n} cw={cw} "
        f"tiles(general,int,float)={torch.bincount(packed.tile_flags, minlength=3).tolist()} "
        f"total_count={total_count} (host {want_count}) total_sum={got_sum!r} "
        f"(host {want_sum!r}) launches={launches}")
    log(f"[main] host encode+prescan {host_s:.2f}s, pack on card {pack_s:.2f}s, "
        f"first call {first_call_s:.3f}s")

    # kernel warm time at the main path's shape
    args = (packed.windows, packed.lanes, packed.tile_flags)
    run_kernel = lambda: fused.lane_aggregates(*args, n=packed.n, k=K)
    run_kernel()
    kernel_ms = statistics.median(cuda_ms(run_kernel, 20))
    kernel_b2b = per_launch_ms(run_kernel)

    # end to end: kernel + per-series and cross-series reductions, to the host
    def e2e():
        o = chunked_scan_aggregate_packed(packed, s=s, c=c, k=K)
        return int(o.total_count)

    e2e()
    e2e_s = []
    for _ in range(10):
        t0 = time.perf_counter()
        e2e()
        e2e_s.append(time.perf_counter() - t0)
    e2e_med = statistics.median(e2e_s)

    # twin on the same inputs: time and per-lane check
    got = run_kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fused.lane_aggregates_reference(*args, n=packed.n, k=K)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(worst, compare_lanes(got, want))
    del want, got

    # least time: the bytes the lanes need, at HBM rate; f32 work: per
    # decoded record 1 add + 2 compares + the value's conversion (<= 8)
    need = needed_bytes(streams, packed, s, K)
    bytes_moved = need["total"]
    f32_ops = total_count * 11
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = f32_ops / F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[main] bytes needed: " + ", ".join(f"{k_} {v / 1e9:.4f} GB" for k_, v in need.items())
        + f" (padded inputs hold {(packed.windows.numel() + packed.lanes.numel()) * 4 / 1e9:.4f} GB)")
    log(f"[main] kernel warm median {kernel_ms:.3f} ms (20 launches, CUDA events; back-to-back "
        f"{kernel_b2b:.3f} ms); "
        f"bound {bound_ms:.3f} ms ({bytes_moved / 1e9:.3f} GB at 3.35 TB/s = "
        f"{bound_ms / kernel_ms:.1%} of roofline; f32 ops "
        f"{ops_ms:.4f} ms); twin {plain_ms:.1f} ms; end to end {e2e_med * 1e3:.3f} ms = "
        f"{total_count / e2e_med:.4e} datapoints/s; max_abs_err {worst!r}")
    log(f"[main] B1 {occupancy('lane_aggregates', cw)}")
    check_no_unaligned_copies("main")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("[main] library_ms: no single PyTorch call computes an M3TSZ decode; null")
    return e2e_med, {
        "name": "lane_aggregates",
        "route": "cuda",
        "source": "m3_tpu_torch/ops/csrc/lane_aggregates.cu",
        "replaces": "m3_tpu/ops/fused.py:610",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def compare_scans(got, want, what: str) -> None:
    """Two ScanAggregates bit-identical, NaN in the same places."""
    import torch

    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None and w is None:
            continue
        g, w = g.cpu(), w.cpu()
        if g.is_floating_point():
            if not torch.equal(g.isnan(), w.isnan()):
                raise AssertionError(f"{what}: {f} NaN pattern differs")
            g, w = (torch.where(x.isnan(), 0.0, x).view(torch.int32) for x in (g, w))
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {f} differs")


def phase_resident(dev, kernels: list, b3_worst: float, main_e2e_s: float) -> None:
    import torch

    from m3_tpu_torch.cache.block_cache import BlockKey
    from m3_tpu_torch.codec.m3tsz import decode
    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.resident import (ResidentOptions, ResidentPool, resident_fetch_arrays,
                                       resident_scan_totals)
    from m3_tpu_torch.resident.scan import _M_STREAMED_BYTES
    from m3_tpu_torch.utils.synthetic import synthetic_streams

    s = RESIDENT_SERIES
    torch.cuda.reset_peak_memory_stats()
    streams = synthetic_streams(N_UNIQUE, N_POINTS, seed=3)
    t0 = time.perf_counter()
    snaps = [chunked.snapshot_stream(x, K) for x in streams]
    prescan_s = time.perf_counter() - t0

    # admission: 16 filesets (volumes) of s/16 series, side snapshots passed
    pool = ResidentPool(ResidentOptions(max_bytes=3 << 30, side_bytes=2 << 30), device=dev)
    per_call = s // RESIDENT_CALLS
    keys = []
    t0 = time.perf_counter()
    for v in range(RESIDENT_CALLS):
        items = [(b"%08d" % i, streams[i % N_UNIQUE], N_POINTS, snaps[i % N_UNIQUE])
                 for i in range(v * per_call, (v + 1) * per_call)]
        res = pool.admit_block("m3", 0, T0, v, items, chunk_k=K)
        if res.admitted != per_call or not res.complete:
            raise AssertionError(f"admission {v}: {res}")
        keys += [BlockKey("m3", 0, it[0], T0, v) for it in items]
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    st = pool.stats()
    if st["side_pack_overflows"]:
        raise AssertionError(f"{st['side_pack_overflows']} lanes admitted without side planes")
    log(f"[resident] admitted {s} series x {N_POINTS} pts (k={K}) in {RESIDENT_CALLS} calls: "
        f"host {admit_s:.2f} s (+ {prescan_s:.2f} s prescan of the {N_UNIQUE} unique streams); "
        f"upload_bytes {st['upload_bytes']} ({st['bytes']} stream bytes resident); pages "
        f"{st['pages_used']}/{st['pages_total']} (occupancy {st['occupancy']:.4f}), side pages "
        f"{st['side_pages_used']}/{st['side_pages_total']}; device buffers "
        f"{pool.device_bytes() / 1e9:.3f} GB")

    # the path, counted: B1 scan, R fetch and B3 scan from residency, with
    # the counts set to 0 just before and read just after
    fused.LAUNCHES = chunked.LAUNCHES = fused.FIELDS_LAUNCHES = 0
    out = resident_scan_totals(pool, keys, device_out=True)
    fetched, fetch_err = resident_fetch_arrays(pool, keys[:FETCH_KEYS])
    t0 = time.perf_counter()
    with pool.read_lease():
        plan = pool.plan_chunked(keys)
    plan_s = time.perf_counter() - t0
    lane_args, s_pad = scan.assemble_resident_lanes(plan, s)
    c = plan.num_chunks
    fused_out = scan.chunked_scan_aggregate_fused(lane_args, s_pad, c, K)
    total_count = int(out.total_count)
    torch.cuda.synchronize()
    launches = {"lane_aggregates": fused.LAUNCHES, "decode_records": chunked.LAUNCHES,
                "lane_aggregates_fields": fused.FIELDS_LAUNCHES}
    log(f"[resident] launches on the resident path (scan, fetch, fused scan): {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the resident path did not launch {name}")

    # check 1: the device assembly == the host packer on the same streams
    batch = chunked.build_chunked(streams, k=K)
    ref = fused.pack_lanes(batch, order="c", device=dev, n_series=s)
    packed, _ = scan.assemble_resident_packed(plan, s)
    for f in ("windows", "lanes", "tile_flags"):
        if not torch.equal(getattr(packed, f), getattr(ref, f)):
            raise AssertionError(f"assemble_resident_packed {f} differs from pack_lanes")
    asm_ms = statistics.median(cuda_ms(lambda: scan.assemble_resident_packed(plan, s), 3))
    lanes_ms = statistics.median(cuda_ms(lambda: scan.assemble_resident_lanes(plan, s), 3))
    del packed
    log(f"[resident] check 1: assemble_resident_packed == pack_lanes(order='c') on windows "
        f"{tuple(ref.windows.shape)}, lanes and tile_flags "
        f"{torch.bincount(ref.tile_flags, minlength=3).tolist()} exactly")

    # check 2: the resident scan == [main]'s packed scan on the same lanes
    main_out = scan.chunked_scan_aggregate_packed(ref, s=s, c=c, k=K)
    compare_scans(out, main_out, "resident_scan_totals vs chunked_scan_aggregate_packed")
    main_count = int(main_out.total_count)
    del ref, main_out
    log(f"[resident] check 2: resident_scan_totals == chunked_scan_aggregate_packed bit for bit "
        f"(total_count {total_count}, total_sum {float(out.total_sum)!r})")

    # check 3: warm scans move no upload bytes; end to end, to a host read
    def e2e():
        return int(resident_scan_totals(pool, keys, device_out=True).total_count)

    before = (pool.upload_bytes, pool._m_upload.value, _M_STREAMED_BYTES.value)
    e2e()
    e2e_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        e2e()
        e2e_s.append(time.perf_counter() - t0)
    after = (pool.upload_bytes, pool._m_upload.value, _M_STREAMED_BYTES.value)
    if after != before:
        raise AssertionError(f"warm resident scans moved upload bytes: {before} -> {after}")
    e2e_med = statistics.median(e2e_s)
    log(f"[resident] check 3: 4 warm scans, upload_bytes / resident_upload_bytes_total / "
        f"scan_streamed_bytes_total flat at {after}")

    # check 4: B3 == twin per lane at full size; its count == [main]'s
    got = fused.lane_aggregates_fields(**lane_args, k=K)
    b3_ms = statistics.median(cuda_ms(lambda: fused.lane_aggregates_fields(**lane_args, k=K), 20))
    b3_b2b = per_launch_ms(lambda: fused.lane_aggregates_fields(**lane_args, k=K))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fused.lane_aggregates_fields_reference(**lane_args, k=K)
    torch.cuda.synchronize()
    b3_plain_ms = (time.perf_counter() - t0) * 1e3
    b3_worst = max(b3_worst, compare_lanes(got, want))
    del got, want
    if int(fused_out.total_count) != main_count:
        raise AssertionError(f"B3 total_count {int(fused_out.total_count)} != [main] {main_count}")
    log(f"[resident] check 4: B3 == twin per lane on {s * c} lanes (max_abs_err {b3_worst!r}); "
        f"B3 scan total_count {int(fused_out.total_count)} == [main]'s")

    # check 5: fetched datapoints == the host decode, bit for bit
    host = [decode(x) for x in streams]
    host_ts = [np.asarray([d.timestamp for d in h], np.int64) for h in host]
    host_vs = [np.asarray([d.value for d in h], np.float64).view(np.int64) for h in host]
    if fetch_err.any() or len(fetched) != min(FETCH_KEYS, s):
        raise AssertionError("resident fetch flagged err lanes or lost keys")
    for i, (ts, vs) in enumerate(fetched):
        u = i % N_UNIQUE
        if not (np.array_equal(ts, host_ts[u]) and np.array_equal(vs.view(np.int64), host_vs[u])):
            raise AssertionError(f"resident fetch of key {i} differs from the host decode")
    log(f"[resident] check 5: resident_fetch_arrays on {len(fetched)} keys == host decode "
        f"(timestamps and f64 values bit for bit)")
    del fetched

    # B3's bound: per lane the window words its chunk occupies, 15 u32 + 2
    # bool fields, 21 bytes out; f32 work as B1's
    cw = lane_args["windows"].shape[1]
    reps = np.bincount(np.arange(s) % N_UNIQUE, minlength=N_UNIQUE)
    words = int((chunk_words(streams, cw, c, K).sum(axis=1) * reps).sum())
    n = s * c
    b3_bytes = words * 4 + n * (15 * 4 + 2) + n * 21
    bytes_ms = b3_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = main_count * 11 / F32_FLOP_PER_S * 1e3
    b3_bound = max(bytes_ms, ops_ms)
    peak = torch.cuda.max_memory_allocated()
    log(f"[resident] host plan_chunked over {s} keys {plan_s * 1e3:.1f} ms; device assembly "
        f"(CUDA events, median of 3): packed 'c' {asm_ms:.3f} ms, per-field {lanes_ms:.3f} ms")
    log(f"[resident] B3 (lane_aggregates_fields) [{n} lanes x {cw} words] warm median "
        f"{b3_ms:.3f} ms (20 launches, CUDA events; back-to-back {b3_b2b:.3f} ms); bound "
        f"{b3_bound:.3f} ms ({b3_bytes / 1e9:.4f} GB at 3.35 TB/s = {b3_bound / b3_ms:.1%} of "
        f"roofline; f32 ops {ops_ms:.4f} ms); twin {b3_plain_ms:.1f} ms; "
        f"{occupancy('lane_aggregates_fields', cw)}")
    check_no_unaligned_copies("resident")
    log(f"[resident] warm resident scan end to end (plan + assembly + B1 + reductions, "
        f"to a host read of total_count) {e2e_med * 1e3:.3f} ms, median of 3 = "
        f"{total_count / e2e_med:.4e} datapoints/s; [main] streamed-packed {main_e2e_s * 1e3:.3f} ms")
    log(f"[resident] peak device memory {peak / 1e9:.2f} GB")
    log("[resident] library_ms for B3: no single PyTorch call computes an M3TSZ decode; null")
    kernels.append({
        "name": "lane_aggregates_fields",
        "route": "cuda",
        "source": "m3_tpu_torch/ops/csrc/lane_aggregates.cu",
        "replaces": "m3_tpu/ops/fused.py:704",
        "launches": launches["lane_aggregates_fields"],
        "max_abs_err": b3_worst,
        "ms": b3_ms,
        "plain_ms": b3_plain_ms,
        "bound_ms": b3_bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    })


def compare_records(got, want, what: str) -> None:
    """Kernel R vs twin: every field exactly equal."""
    import torch

    for f in ("ts", "bits", "point_is_float", "mult", "valid", "err"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            bad = torch.nonzero(getattr(got, f) != getattr(want, f))[:3].tolist()
            raise AssertionError(f"{what}: {f} differs between kernel R and twin at {bad}")


def phase_records(dev) -> None:
    import torch

    from m3_tpu_torch.ops import chunked, fused

    for kind, _, _ in KINDS:
        batch = chunked.build_chunked(phase_streams(kind), k=K)
        p = fused.pack_lanes(batch, order="s", device=dev, n_series=PARITY_SERIES)
        got = chunked.decode_chunked_lanes(p.windows, p.lanes, n=p.n, k=K)
        torch.cuda.synchronize()
        want = chunked.decode_chunked_lanes_reference(p.windows, p.lanes, n=p.n, k=K)
        compare_records(got, want, kind)
        log(f"[records] {kind:8s} lanes={p.n} records={p.n * K} valid={int(want.valid.sum())} "
            f"float_points={int((want.point_is_float & want.valid).sum())} "
            f"err_lanes={int(want.err.sum())}: kernel == twin on every field")
    check_no_unaligned_copies("records")


def compare_temporal(name: str, got, want, what: str) -> float:
    """B2 vs twin: NaN pattern identical, values within 1e-4 abs + 1e-4
    rel (5e-3 abs for stddev/stdvar). Returns the largest abs difference."""
    import torch

    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what} {name}: NaN pattern differs between B2 and twin")
    ok = ~torch.isnan(want)
    if not bool(ok.any()):
        return 0.0
    diff = (got[ok] - want[ok]).abs()
    atol = 5e-3 if name.startswith("std") else 1e-4
    if not bool((diff <= atol + 1e-4 * want[ok].abs()).all()):
        raise AssertionError(f"{what} {name}: beyond the bound, max abs diff {float(diff.max())}")
    return float(diff.max())


def phase_temporal(dev) -> float:
    import torch

    from m3_tpu_torch.query.functions import temporal_fused as TF

    rng = np.random.default_rng(3)
    v = rng.normal(100, 10, (PARITY_SERIES, N_POINTS)).astype(np.float32)
    v[rng.random(v.shape) < 0.02] = np.nan
    v[11] = np.nan
    x = torch.from_numpy(v).to(dev)
    worst = 0.0
    for w in (1, 7, 61, 1000):
        got = TF.fused_temporal(x, w, 10.0, tuple(TF.FUSABLE))
        torch.cuda.synchronize()
        errs = []
        for name, g in zip(TF.FUSABLE, got):
            errs.append(compare_temporal(name, g, TF.FUSABLE[name](x, w, 10.0), f"w={w}"))
        worst = max(worst, max(errs))
        ms = statistics.median(cuda_ms(lambda: TF.fused_temporal(x, w, 10.0, tuple(TF.FUSABLE)), 5))
        log(f"[temporal] [{PARITY_SERIES}, {N_POINTS}] w={w}: 15 functions in one launch "
            f"{ms:.3f} ms (median of 5, CUDA events), NaN patterns identical, max_abs_err " + " ".join(
                f"{n}={e:.3g}" for n, e in zip(TF.FUSABLE, errs)))
    return worst


def per_launch_ms(fn, launches: int = 20) -> float:
    """Device time per launch of a run of back-to-back launches, between two
    CUDA events (the host enqueues ahead of the card)."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / launches


def phase_temporal_sizes(dev) -> float:
    """B2's one-function kernels at the query's size, [100000, 726]: each of
    the 15 functions alone at w=7, and avg_over_time and rate at windows
    1/7/61/1000, each held against its twin on the same input and timed
    beside the bytes bound and F.avg_pool1d at the same window. Returns the
    largest abs difference from the twin."""
    import torch
    import torch.nn.functional as F

    from m3_tpu_torch.query.functions import temporal_fused as TF

    rows, cols = QUERY_SERIES, N_POINTS + 6
    rng = np.random.default_rng(4)
    v = rng.normal(100, 10, (rows, cols)).astype(np.float32)
    v[rng.random(v.shape) < 0.02] = np.nan
    x = torch.from_numpy(v).to(dev)
    del v
    bound = 2 * rows * cols * 4 / HBM_BYTES_PER_S * 1e3
    filled = x.nan_to_num(0.0)
    worst = 0.0

    def pool_ms(w):
        padded = torch.nn.functional.pad(filled, (w - 1, 0))[:, None, :]
        run = lambda: F.avg_pool1d(padded, w, stride=1)
        return statistics.median(cuda_ms(run, 10)), per_launch_ms(run)

    def one(name, w):
        nonlocal worst
        (got,) = TF.fused_temporal(x, w, 10.0, (name,))
        err = compare_temporal(name, got, TF.FUSABLE[name](x, w, 10.0), f"[{rows}, {cols}] w={w}")
        worst = max(worst, err)
        del got
        run = lambda: TF.fused_temporal(x, w, 10.0, (name,))
        return statistics.median(cuda_ms(run, 20)), per_launch_ms(run), err

    pool = {w: pool_ms(w) for w in (1, 7, 61, 1000)}
    log(f"[temporal] one-function kernels on f32 [{rows}, {cols}] (2% NaN, seed 4); bound "
        f"{bound:.3f} ms (one f32 [S, T] in and out at 3.35 TB/s); F.avg_pool1d yardstick "
        + ", ".join(f"w={w} {ms:.3f} ms (back-to-back {b2b:.3f})" for w, (ms, b2b) in pool.items())
        + "; ms = median of 20 single launches (CUDA events), back-to-back = 20 launches "
        "between two events")
    at7 = {}
    for name in TF.FUSABLE:
        ms, b2b, err = one(name, 7)
        at7[name] = (ms, b2b)
        log(f"[temporal] w=7 {name:17s} {ms:.3f} ms (back-to-back {b2b:.3f}); bound "
            f"{bound:.3f} ms = {bound / ms:.1%} of roofline; avg_pool1d {pool[7][0]:.3f} ms; "
            f"max_abs_err vs twin {err:.3g}")
    for name in ("avg_over_time", "rate"):
        (ms, b2b), (p_ms, p_b2b) = at7[name], pool[7]
        log(f"[temporal] w=7 {name} vs F.avg_pool1d: {ms:.3f} vs {p_ms:.3f} ms single, "
            f"{b2b:.3f} vs {p_b2b:.3f} ms back-to-back: "
            + ("faster in both" if ms < p_ms and b2b < p_b2b else "NOT faster in both"))
    for name in ("avg_over_time", "rate"):
        for w in (1, 7, 61, 1000):
            ms, b2b, err = one(name, w)
            log(f"[temporal] sweep {name:13s} w={w:<4d} {ms:.3f} ms (back-to-back {b2b:.3f}); "
                f"bound {bound:.3f} ms; avg_pool1d {pool[w][0]:.3f} ms; max_abs_err {err:.3g}")
    return worst


def phase_query(dev, kernels: list, temporal_err: float) -> None:
    import torch

    from m3_tpu_torch.block.core import Bounds, make_tags
    from m3_tpu_torch.codec.m3tsz import decode
    from m3_tpu_torch.ops import chunked
    from m3_tpu_torch.query import engine as E
    from m3_tpu_torch.query.functions import aggregation as A
    from m3_tpu_torch.query.functions import temporal_fused as TF
    from m3_tpu_torch.query.m3_storage import BlockStorage
    from m3_tpu_torch.query.plan import consolidate_grid
    from m3_tpu_torch.query.promql import Matcher
    from m3_tpu_torch.utils.synthetic import synthetic_streams

    s_q = QUERY_SERIES
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streams = synthetic_streams(N_UNIQUE, N_POINTS, seed=3)
    tags = [make_tags({"__name__": "m3_scan", "job": f"job-{i % QUERY_JOBS}", "host": f"h{i}"})
            for i in range(s_q)]
    storage = BlockStorage(streams, tags, k=K, device=dev)
    eng = E.Engine(storage, device=dev)
    torch.cuda.synchronize()
    log(f"[query] block: {s_q} series x {N_POINTS} pts, {N_UNIQUE} unique gauge streams, "
        f"k={K}, C={storage.num_chunks}, lanes={s_q * storage.num_chunks}, "
        f"cw={storage.packed.windows.shape[0]}; set-up {time.perf_counter() - t0:.2f}s")

    start, end = T0, T0 + (N_POINTS - 1) * STEP
    queries = {"rate": "sum by (job) (rate(m3_scan[1m]))",
               "avg_over_time": "avg by (job) (avg_over_time(m3_scan[1m]))"}
    window = 60 * 10**9 // STEP + 1

    # the main path, counted: both queries once, counts set to 0 just before
    chunked.LAUNCHES = 0
    TF.LAUNCHES = 0
    results = {fn: eng.query_range(q, start, end, STEP) for fn, q in queries.items()}
    torch.cuda.synchronize()
    launches = {"decode_records": chunked.LAUNCHES, "temporal_fused": TF.LAUNCHES}
    log(f"[query] launches on the main path (2 queries): {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the query path did not launch {name}")

    # check 1: the grid of the unique rows equals the host decode +
    # consolidate_row bit for bit
    lookback = eng.lookback
    g_start = start - (window - 1) * STEP
    g_end = start + STEP * (N_POINTS)
    grid = Bounds(g_start, STEP, N_POINTS + window - 1).timestamps()
    lo, hi = g_start - lookback, g_end
    metas, values, datapoints = storage.fetch_grid(
        [Matcher("__name__", "=", "m3_scan")], lo, hi, grid, lookback)
    host_grid = np.stack([E.consolidate_row(
        np.asarray([dp.timestamp for dp in d if lo <= dp.timestamp < hi], np.int64),
        np.asarray([dp.value for dp in d if lo <= dp.timestamp < hi], np.float64),
        grid, lookback) for d in (decode(x) for x in streams)])
    dev_grid = values[:N_UNIQUE].cpu().numpy()
    if not np.array_equal(dev_grid.view(np.int64), host_grid.view(np.int64)):
        raise AssertionError("query grid of the unique rows differs from the host decode")
    if values.shape != (s_q, N_POINTS + window - 1) or len(metas) != s_q:
        raise AssertionError(f"query grid shape {tuple(values.shape)}")
    log(f"[query] grid [{s_q}, {values.shape[1]}] f64, {datapoints} datapoints; unique rows "
        f"== host decode + consolidate_row bit for bit")

    # check 2: each job's result == f64 sum of the unique rows' twin outputs
    # weighted by their multiplicity
    idx = np.arange(s_q)
    mult = np.zeros((N_UNIQUE, QUERY_JOBS))
    np.add.at(mult, (idx % N_UNIQUE, idx % QUERY_JOBS), 1.0)
    uniq = values[:N_UNIQUE].to(torch.float32)
    for fn, res in results.items():
        out = TF.FUSABLE[fn](uniq, window, STEP / 1e9)[:, window - 1:].double().cpu().numpy()
        valid = ~np.isnan(out)
        s = mult.T @ np.where(valid, out, 0.0)
        c = mult.T @ valid.astype(np.float64)
        want = np.where(c > 0, s if fn == "rate" else s / np.maximum(c, 1), np.nan)
        got = res.values.double().cpu().numpy()
        order = [int(dict(m.tags)[b"job"].split(b"-")[1]) for m in res.metas]
        want = want[order]
        if got.shape != (QUERY_JOBS, N_POINTS) or not np.array_equal(np.isnan(got), np.isnan(want)):
            raise AssertionError(f"{queries[fn]}: shape or NaN pattern differs from the f64 check")
        ok = ~np.isnan(want)
        rel = float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]))) if ok.any() else 0.0
        if not (ok.any() and rel <= 1e-4):
            raise AssertionError(f"{queries[fn]}: rel err {rel} vs the f64 check")
        log(f"[query] {queries[fn]}: [{QUERY_JOBS}, {N_POINTS}], {int(ok.sum())} finite, max rel "
            f"err {rel:.3g} vs the f64 sum of the unique rows' twin outputs")

    # stage times at this shape (CUDA events, median)
    c = storage.num_chunks
    n = s_q * c
    pk = storage.packed
    # R's input as fetch_grid gathers it: the matched series' lanes in arrays
    # of their own, [CW, 3,000,000] (not a multiple of the 128-lane slab)
    sel = storage.match([Matcher("__name__", "=", "m3_scan")])
    lanes_q = (torch.from_numpy(sel).to(dev)[:, None] * c
               + torch.arange(c, device=dev)[None, :]).reshape(-1)
    qw, ql = pk.windows[:, lanes_q], pk.lanes[:, lanes_q]
    del lanes_q
    run_r = lambda: chunked.decode_chunked_lanes(qw, ql, n=n, k=K)
    rec = run_r()
    r_ms = statistics.median(cuda_ms(run_r, 10))
    r_b2b = per_launch_ms(run_r)
    rec_s = chunked.decode_chunked(pk.windows, pk.lanes, s_q, c, K)
    cons_ms = statistics.median(cuda_ms(lambda: consolidate_grid(rec_s, lo, hi, grid, lookback), 5))
    grid32 = values.to(torch.float32)
    b2 = {fn: statistics.median(cuda_ms(
        lambda fn=fn: TF.fused_temporal(grid32, window, STEP / 1e9, (fn,)), 20)) for fn in queries}
    b2_b2b = {fn: per_launch_ms(lambda fn=fn: TF.fused_temporal(grid32, window, STEP / 1e9, (fn,)))
              for fn in queries}
    out_avg = TF.fused_temporal(grid32, window, STEP / 1e9, ("avg_over_time",))[0]
    out_rate = TF.fused_temporal(grid32, window, STEP / 1e9, ("rate",))[0]
    t0 = time.perf_counter()
    layout = A.group_by_tags(metas, [b"job"])
    group_s = time.perf_counter() - t0
    agg_ms = statistics.median(cuda_ms(lambda: A.grouped_sum(out_rate[:, window - 1:], layout), 20))

    e2e = {}
    for fn, q in queries.items():
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.query_range(q, start, end, STEP).values.cpu()
            times.append(time.perf_counter() - t0)
        e2e[fn] = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()

    # device busy share of one warm query: the profiler's device time of
    # every kernel and copy (the device-side events only: an op's own entry
    # repeats the time of the kernels it launched) over the query's
    # host-clock time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for fn, q in queries.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.query_range(q, start, end, STEP).values.cpu()
            wall = time.perf_counter() - t0
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        busy[fn] = (dev_us / 1e3, wall * 1e3)

    # twins on the same inputs: time and check
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_twin = chunked.decode_chunked_lanes_reference(qw, ql, n=n, k=K)
    torch.cuda.synchronize()
    r_plain_ms = (time.perf_counter() - t0) * 1e3
    compare_records(rec, rec_twin, "query block")
    del rec_twin
    b2_plain, b2_err = {}, 0.0
    for fn, got in (("rate", out_rate), ("avg_over_time", out_avg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = TF.FUSABLE[fn](grid32, window, STEP / 1e9)
        torch.cuda.synchronize()
        b2_plain[fn] = (time.perf_counter() - t0) * 1e3
        b2_err = max(b2_err, compare_temporal(fn, got, want, "query block"))

    # library yardstick for B2: avg_pool1d over the zero-filled matrix,
    # left-padded by window - 1 zeros, is the NaN-free avg_over_time of the
    # full windows (it divides by the window, not by the valid count)
    import torch.nn.functional as F

    padded = torch.nn.functional.pad(grid32.nan_to_num(0.0), (window - 1, 0))[:, None, :]
    lib_ms = statistics.median(cuda_ms(lambda: F.avg_pool1d(padded, window, stride=1), 20))
    lib_b2b = per_launch_ms(lambda: F.avg_pool1d(padded, window, stride=1))
    del padded

    # bounds: kernel R reads each lane's window words and 17 planes once and
    # writes 19 bytes per record and 1 per lane; B2 reads and writes one
    # f32 [S, T] per function (ops: 2 per window element for avg_over_time)
    words_u = chunk_words(streams, pk.windows.shape[0], c, K)
    reps = np.bincount(np.arange(s_q) % N_UNIQUE, minlength=N_UNIQUE)
    r_bytes = int((words_u.sum(axis=1) * reps).sum()) * 4 + n * 17 * 4 + n * K * 19 + n
    r_bound = r_bytes / HBM_BYTES_PER_S * 1e3
    rows, cols = grid32.shape
    b2_bytes = 2 * rows * cols * 4
    b2_bytes_ms = b2_bytes / HBM_BYTES_PER_S * 1e3
    win_elems = sum(min(window, t + 1) for t in range(cols))
    b2_ops_ms = rows * (2 * win_elems + cols) / F32_FLOP_PER_S * 1e3
    b2_bound = max(b2_bytes_ms, b2_ops_ms)
    log(f"[query] kernel R (decode_records) [{n} lanes x {K}, gathered as fetch_grid gathers "
        f"them] {r_ms:.3f} ms (median of 10, CUDA events; back-to-back {r_b2b:.3f} ms); bound "
        f"{r_bound:.3f} ms ({r_bytes / 1e9:.4f} GB at 3.35 TB/s = {r_bound / r_ms:.1%} of "
        f"roofline); twin {r_plain_ms:.1f} ms; {occupancy('decode_records', qw.shape[0])}")
    log(f"[query] consolidation (plain torch) [{s_q}, {c * K}] -> [{s_q}, {cols}] {cons_ms:.3f} ms")
    for fn in queries:
        log(f"[query] B2 (temporal_fused) {fn} [{rows}, {cols}] w={window}: {b2[fn]:.3f} ms (median "
            f"of 20; back-to-back {b2_b2b[fn]:.3f} ms); bound {b2_bound:.3f} ms ({b2_bytes / 1e9:.4f} GB at 3.35 TB/s = "
            f"{b2_bound / b2[fn]:.1%} of roofline; f32 ops {b2_ops_ms:.4f} ms); twin "
            f"{b2_plain[fn]:.1f} ms")
    log(f"[query] B2 library yardstick: F.avg_pool1d over the zero-filled, left-padded matrix "
        f"{lib_ms:.3f} ms (back-to-back {lib_b2b:.3f} ms); it computes only the NaN-free avg_over_time (no NaN gate, no "
        f"valid count); none exists for rate (null)")
    log(f"[query] aggregation: group_by_tags (host) {group_s * 1e3:.1f} ms, grouped_sum "
        f"[{rows}, {cols - window + 1}] -> [{QUERY_JOBS}, ...] {agg_ms:.3f} ms")
    for fn, q in queries.items():
        log(f"[query] end to end {q}: {e2e[fn] * 1e3:.3f} ms (median of 10, host clock, "
            f"ending in a host copy)")
    for fn, q in queries.items():
        dev_ms, wall_ms = busy[fn]
        share = f"device busy {dev_ms / wall_ms:.1%}" if dev_ms > 0 else "device time not measured"
        log(f"[query] profiled {q}: device time {dev_ms:.3f} ms of {wall_ms:.3f} ms ({share})")
    check_no_unaligned_copies("query")
    log(f"[query] peak device memory {peak / 1e9:.2f} GB")
    kernels += [{
        "name": "decode_records",
        "route": "cuda",
        "source": "m3_tpu_torch/ops/csrc/lane_aggregates.cu",
        "replaces": "m3_tpu/ops/chunked.py:460",
        "launches": launches["decode_records"],
        "max_abs_err": 0,
        "ms": r_ms,
        "plain_ms": r_plain_ms,
        "bound_ms": r_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "temporal_fused",
        "route": "cuda",
        "source": "m3_tpu_torch/query/functions/csrc/temporal_fused.cu",
        "replaces": "m3_tpu/query/functions/temporal_fused.py:77",
        "launches": launches["temporal_fused"],
        "max_abs_err": max(b2_err, temporal_err),
        "ms": b2["avg_over_time"],
        "plain_ms": b2_plain["avg_over_time"],
        "bound_ms": b2_bound,
        "bound_by": "bytes" if b2_bytes_ms >= b2_ops_ms else "operations",
        "library_ms": lib_ms,
    }]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from m3_tpu_torch.ops import _build

    dev = DEVICE
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {', '.join(_build.SOURCES)} built in parallel in "
        f"{time.perf_counter() - t0:.2f}s")
    for lib, text in _build.BUILD_LOG.items():
        log(f"[build] {lib}:\n{text.strip()}")

    worst = phase_parity(dev)
    b3_worst = phase_parity_fields(dev)
    main_e2e_s, b1 = phase_main(dev, worst)
    kernels = [b1]
    phase_resident(dev, kernels, b3_worst, main_e2e_s)
    phase_records(dev)
    temporal_err = phase_temporal(dev)
    temporal_err = max(temporal_err, phase_temporal_sizes(dev))
    phase_query(dev, kernels, temporal_err)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
