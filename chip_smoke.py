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
             yardstick and the peak device memory. BlockStorage resolves
             matchers through the index (its segment resident in a
             DeviceIndexStore): K1 and K2 launch, no store miss. A third
             query in BASELINE config 5's shape,
             sum(rate(m3_scan{host=~"h1.*"}[1m])) (a fan-out prefix regexp
             over 11,111 series, one group), is held to an f64 sum as
             above; each query run twice is bit-identical; K3 (the grouped
             reductions) equals its twin on a CPU copy bit for bit for all
             seven ops, and its sum is timed with pad_index already on the
             card, beside index_add_ and its bound (the larger of the bytes
             and the fold's chain of dependent adds at the SM clock), at 10
             groups, at one group of all 100,000 series (a plain sum over
             the block) and at the fan-out query's [11,111, 720] into one
             group, with the column-block width it picked.
  index    — the inverted index at the TSBS devops cpu scale: 100,000 hosts
             x 10 cpu fields = 1,000,000 series, each with __name__ and
             TSBS's 10 host tags, values drawn from --seed over TSBS's value
             sets, written into a NamespaceIndex with a DeviceIndexStore as
             one block, and the first 10,000 hosts' series as a second block.
             Six TSBS query shapes as matchers through NamespaceIndex.query
             over both blocks (prematch batching K1 across the two resident
             segments): doc ids == the host executor's exactly; every
             segment resident, 0 misses, 0 errors; K1 and K2 launched, K2 at
             most once per segment and query. Then the launch floor (an empty
             kernel through the same route), K1 at query 2's batched shape
             (and match_rows around it: one pinned upload, one read back) and
             K2 over one span of 1M postings and over one term, single-launch
             and back to back, beside their bounds, the floor and their twins
             (K2 also against a second run), and each query's host time end
             to end (median of 10).
  database — one storage node in process at BASELINE config 3's scale: the
             [query] block's 100,000 series x 720 points (the 64 unique
             gauge streams of seed 3 from a block start, tiled; tags
             __name__=m3_scan, job, host) written as the 8 shards' filesets
             of one 2-hour block, then a Database (8 shards, commit log on,
             residency on, the device index on) bootstrapped over them
             (filesystem source, re-index, re-admission). 1,000 series x 360
             points of live writes into the next block (write_tagged_batch):
             a scan of those series over both blocks streams (buffered
             overlay); the flush of that block admits at seal. Engine over M3Storage (the staged
             path) runs sum by (job) (rate(m3_scan[1m])) and avg by (job)
             (avg_over_time(m3_scan[1m])), each bit-identical to the same
             query over BlockStorage on the same streams; scan_totals is
             resident and bit-identical to chunked_scan_aggregate_packed over
             the same streams, and warm repeats move 0 upload bytes. After
             resident_clear a scan of the 1,000 live series streams with the
             same bits, read-through re-admission brings every lane back, and
             the next scans are resident. The streamed scans read that slice
             only: each streamed series pays its prescan in Python, timed on
             its own. Restart: close, a new Database over the directory,
             bootstrap; every acknowledged live write reads back equal and
             the sealed blocks are resident again. Kernel B-2 == its twin bit
             for bit here and in [resident] (1M series), K3 on subnormal
             inputs == its flushed twin. Prints the bootstrap seconds, each
             query's end-to-end median, the scans' end-to-end times, B-2's
             time beside its bound, its twin's and the series its direct
             route took, and the node's resident and index stats.
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
CHAIN_CYCLES = 4  # latency of a dependent f32 add on Hopper: K3's row-order fold is a chain of them
PARITY_SERIES, MAIN_SERIES, N_POINTS, K, N_UNIQUE = 4096, 1 << 20, 720, 24, 64
QUERY_SERIES, QUERY_JOBS, STEP = 100_000, 10, 10 * 10**9
INDEX_HOSTS, INDEX_SECOND_BLOCK_HOSTS, HOUR = 100_000, 10_000, 3600 * 10**9
# TSBS devops: the cpu measurement's fields and the host tags' value sets
# (pkg/data/usecases/devops/host.go)
CPU_FIELDS = ["usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
              "usage_irq", "usage_softirq", "usage_steal", "usage_guest", "usage_guest_nice"]
TSBS_REGIONS = {
    "us-east-1": ["us-east-1a", "us-east-1b", "us-east-1c", "us-east-1e"],
    "us-west-1": ["us-west-1a", "us-west-1b"],
    "us-west-2": ["us-west-2a", "us-west-2b", "us-west-2c"],
    "eu-west-1": ["eu-west-1a", "eu-west-1b", "eu-west-1c"],
    "eu-central-1": ["eu-central-1a", "eu-central-1b"],
    "ap-southeast-1": ["ap-southeast-1a", "ap-southeast-1b"],
    "ap-southeast-2": ["ap-southeast-2a", "ap-southeast-2b"],
    "ap-northeast-1": ["ap-northeast-1a", "ap-northeast-1c"],
    "sa-east-1": ["sa-east-1a", "sa-east-1b", "sa-east-1c"],
}
TSBS_CHOICES = {
    "rack": [str(i) for i in range(100)],
    "os": ["Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10"],
    "arch": ["x64", "x86"],
    "team": ["SF", "NYC", "LON", "CHI"],
    "service": [str(i) for i in range(20)],
    "service_version": ["0", "1"],
    "service_environment": ["production", "staging", "test"],
}
SEED = 6
FANOUT_QUERY = 'sum(rate(m3_scan{host=~"h1.*"}[1m]))'
RESIDENT_SERIES, RESIDENT_CALLS, FETCH_KEYS = 1 << 20, 16, 100_000
T0 = 1_600_000_000 * 10**9
# [database]: BASELINE config 3's block through a storage node (8 shards,
# the Database's default) plus live writes into the next block (a power of
# ten of series). A staged query takes seconds end to end, so each is timed
# over DB_QUERY_RUNS runs to keep the phase near 3 minutes
DB_SERIES, DB_SHARDS, DB_LIVE_SERIES, DB_LIVE_POINTS, DB_QUERY_RUNS = 100_000, 8, 1_000, 360, 3
BLOCK = 2 * 3600 * 10**9  # the Database's default block size
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


def same_bits(a, b) -> bool:
    """Two float tensors hold the same bits (NaN in the same places)."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.where(a.isnan(), 0.0, a).view(as_int), torch.where(b.isnan(), 0.0, b).view(as_int))


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


def phase_resident(dev, kernels: list, b3_worst: float, main_e2e_s: float) -> dict:
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
    fused.LAUNCHES = chunked.LAUNCHES = fused.FIELDS_LAUNCHES = scan.ASSEMBLY_LAUNCHES = 0
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
                "lane_aggregates_fields": fused.FIELDS_LAUNCHES,
                "resident_assembly": scan.ASSEMBLY_LAUNCHES}
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
    log(f"[resident] check 1: assemble_resident_packed (kernel B-2) == pack_lanes(order='c') "
        f"on windows {tuple(ref.windows.shape)}, lanes and tile_flags "
        f"{torch.bincount(ref.tile_flags, minlength=3).tolist()} exactly")
    b2 = b2_check(plan, s, "resident")

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
        f"with the plan's uploads (B-2, CUDA events, median of 3): packed 'c' {asm_ms:.3f} ms, "
        f"per-field {lanes_ms:.3f} ms")
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
    return b2


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


def b2_check(plan, s_pad: int, tag: str) -> dict:
    """Kernel B-2 (the resident lane assembly) against its plain torch twin
    on the card, bit for bit, in all three outputs it gives (B1's packed
    chunk-major lanes, R's series-major lanes, B3's per-field lanes). Then
    its time on B1's layout (CUDA events, median of 20, and back to back)
    with the plan's vectors already on the card, the twin's time, and the
    bytes bound: the pool's stream words, each valid lane's side row and
    the plan's vectors read once, the windows, planes and tile flags
    written once."""
    import torch

    from m3_tpu_torch.parallel import scan

    vecs = scan.plan_vectors(plan, s_pad)
    for order in ("c", "s"):
        got, _ = scan.assemble_resident_packed(plan, s_pad, order=order)
        want, _ = scan.assemble_resident_packed_reference(plan, s_pad, order=order)
        for f in ("windows", "lanes", "tile_flags"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"[{tag}] B-2 order {order!r}: {f} differs from its twin")
        del got, want
    got, _ = scan.assemble_resident_lanes(plan, s_pad)
    want, _ = scan.assemble_resident_lanes_reference(plan, s_pad)
    for f, x in want.items():
        for a, b in zip(got[f] if isinstance(x, tuple) else (got[f],),
                        x if isinstance(x, tuple) else (x,)):
            if not torch.equal(a, b):
                raise AssertionError(f"[{tag}] B-2 per-field lanes: {f} differs from its twin")
    del got, want
    tile = 32 * 128
    run = lambda: scan._launch_assembly(plan, s_pad, "c", False, tile, vecs)
    ms = statistics.median(cuda_ms(run, 20))
    b2b = per_launch_ms(run)
    direct = scan.ASSEMBLY_DIRECT_SERIES
    windows, planes, flags, n = run()
    direct = scan.ASSEMBLY_DIRECT_SERIES - direct
    with_chunks = int((plan.n_chunks > 0).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan.assemble_resident_packed_reference(plan, s_pad, order="c")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    valid_lanes = int(plan.n_chunks.astype(np.int64).sum())
    bytes_in = (int(((plan.total_bits.astype(np.int64) + 31) // 32).sum()) * 4
                + valid_lanes * 40 + sum(v.numel() * 4 for v in vecs))
    bytes_out = (windows.numel() + planes.numel() + flags.numel()) * 4
    bound = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] B-2 (resident_assembly) == its twin bit for bit on B1's, R's and B3's "
        f"layouts; [{n} lanes, cw {plan.window_words}] {ms:.3f} ms (median of 20, CUDA "
        f"events; back-to-back {b2b:.3f} ms), bound {bound:.3f} ms ({(bytes_in + bytes_out) / 1e9:.4f} "
        f"GB: {bytes_in / 1e9:.4f} in, {bytes_out / 1e9:.4f} out, at 3.35 TB/s = "
        f"{bound / ms:.1%} of roofline); direct-route series {direct} of {with_chunks}; twin "
        f"{plain_ms:.1f} ms")
    return {"ms": ms, "b2b": b2b, "plain_ms": plain_ms, "bound_ms": bound, "lanes": n,
            "direct": direct}


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
    from m3_tpu_torch.index.device import kernels as IK
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

    # the main path, counted: the three queries once, counts set to 0 just
    # before and read just after
    chunked.LAUNCHES = 0
    TF.LAUNCHES = 0
    A.LAUNCHES = 0
    for k in IK.LAUNCHES:
        IK.LAUNCHES[k] = 0
    results = {fn: eng.query_range(q, start, end, STEP) for fn, q in queries.items()}
    fanout = eng.query_range(FANOUT_QUERY, start, end, STEP)
    torch.cuda.synchronize()
    launches = {"decode_records": chunked.LAUNCHES, "temporal_fused": TF.LAUNCHES,
                "grouped_reduce": A.LAUNCHES, "index_match_terms": IK.LAUNCHES["match_terms"],
                "index_bitmap": IK.LAUNCHES["bitmap_from_spans"]}
    log(f"[query] launches on the main path (3 queries): {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the query path did not launch {name}")
    st = storage.index_store.stats()
    if st["search_misses"] or st["errors"] or not st["search_hits"]:
        raise AssertionError(f"[query] matchers did not resolve on the device index: {st}")
    log(f"[query] BlockStorage's index store: {st}")

    # each query run again gives the same bits
    for q, first in [(q, results[fn]) for fn, q in queries.items()] + [(FANOUT_QUERY, fanout)]:
        if not same_bits(eng.query_range(q, start, end, STEP).values, first.values):
            raise AssertionError(f"{q}: a second run differs from the first")
    log("[query] each of the 3 queries run twice: bit-identical results")

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
    # config 5's shape: the series whose host starts with h1, one group
    hit = np.asarray([str(i).startswith("1") for i in range(s_q)])
    mult_f = np.bincount(idx[hit] % N_UNIQUE, minlength=N_UNIQUE).astype(np.float64)
    out = TF.FUSABLE["rate"](uniq, window, STEP / 1e9)[:, window - 1:].double().cpu().numpy()
    valid = ~np.isnan(out)
    s = mult_f @ np.where(valid, out, 0.0)
    c = mult_f @ valid.astype(np.float64)
    want = np.where(c > 0, s, np.nan)[None, :]
    got = fanout.values.double().cpu().numpy()
    ok = ~np.isnan(want)
    rel = float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]))) if ok.any() else 0.0
    if got.shape != (1, N_POINTS) or not np.array_equal(np.isnan(got), np.isnan(want)) or not (
            ok.any() and rel <= 1e-4):
        raise AssertionError(f"{FANOUT_QUERY}: shape, NaN pattern or rel err {rel} vs f64")
    log(f"[query] {FANOUT_QUERY}: {int(hit.sum())} series matched through the index, [1, "
        f"{N_POINTS}], {int(ok.sum())} finite, max rel err {rel:.3g} vs the f64 check")

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
    agg_x = out_rate[:, window - 1:].contiguous()
    # K3 == its twin on a CPU copy of the same values, all seven ops
    agg_cpu = agg_x.cpu()
    for op in A.OPS:
        if not same_bits(A.grouped_reduce(agg_x, layout, op), A.grouped_reduce(agg_cpu, layout, op)):
            raise AssertionError(f"K3 {op} differs from its twin on the CPU")
    log(f"[query] K3 (grouped_reduce) == its twin on a CPU copy bit for bit: {', '.join(A.OPS)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A.grouped_reduce_reference(agg_x, layout, "sum")
    torch.cuda.synchronize()
    k3_plain = (time.perf_counter() - t0) * 1e3
    # K3's three shapes: the query's 10 groups, one group of every series
    # of the block (a plain sum(...)), and the fan-out query's one group
    clock_hz = sm_clock_hz()
    k3 = {"10 groups": k3_times(agg_x, layout, dev, clock_hz)}
    k3["one group"] = k3_times(agg_x, A.group_by_tags(metas), dev, clock_hz)
    hit_rows = torch.from_numpy(np.flatnonzero(hit)).to(dev)
    k3["fan-out"] = k3_times(agg_x[hit_rows].contiguous(),
                             A.group_by_tags([metas[i] for i in np.flatnonzero(hit)]), dev,
                             clock_hz)
    del agg_cpu, hit_rows

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
    log(f"[query] aggregation: group_by_tags (host) {group_s * 1e3:.1f} ms; K3's twin (sum, 10 "
        f"groups) {k3_plain:.1f} ms")
    for what, k in k3.items():
        log(f"[query] K3 (grouped_reduce) sum {k['shape']} -> {what} ({k['groups']} x "
            f"{k['members']} members at most): WC {k['wc']}, {k['ms']:.3f} ms (pad_index on the "
            f"card; median of 20, CUDA events; back-to-back {k['b2b']:.3f} ms), with the wrapper's "
            f"pad_index copy {k['wrapper_ms']:.3f} ms; bound {k['bound_ms']:.3f} ms = max(bytes "
            f"{k['bytes_ms']:.3f} ms: {k['bytes'] / 1e9:.4f} GB at 3.35 TB/s, chain "
            f"{k['chain_ms']:.3f} ms: {k['members']} dependent adds x {CHAIN_CYCLES} cycles at "
            f"{clock_hz / 1e6:.0f} MHz) = {k['bound_ms'] / k['ms']:.1%} of it; index_add_ (the "
            f"same sum, atomics) {k['lib_ms']:.3f} ms: K3 "
            f"{'faster' if k['ms'] < k['lib_ms'] else 'NOT faster'}; == twin bit for bit")
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
    }, {
        "name": "grouped_reduce",
        "route": "cuda",
        "source": "m3_tpu_torch/query/functions/csrc/grouped_reduce.cu",
        "replaces": "m3_tpu/query/functions/aggregation.py:95",
        "launches": launches["grouped_reduce"],
        "max_abs_err": 0,
        "ms": k3["10 groups"]["ms"],
        "plain_ms": k3_plain,
        "bound_ms": k3["10 groups"]["bound_ms"],
        "bound_by": k3["10 groups"]["bound_by"],
        "library_ms": k3["10 groups"]["lib_ms"],
    }]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def k3_times(x, layout, dev, clock_hz: float) -> dict:
    """K3's grouped sum of f32 [rows, cols] into the layout's groups, held
    to its twin on a CPU copy, then timed with pad_index already on the card
    (and through the wrapper, which copies it), beside index_add_ of the
    same sum and the bound: the larger of the bytes (values read once, the
    outputs and pad_index once) and the fold's chain, the largest group's
    members as dependent adds at CHAIN_CYCLES each at the SM clock."""
    import torch

    from m3_tpu_torch.ops._build import load_library
    from m3_tpu_torch.query.functions import aggregation as A

    pad = torch.from_numpy(np.ascontiguousarray(layout.pad_index, np.int32)).to(dev)
    run = lambda: A.launch_grouped_reduce(x, pad, "sum")
    if not same_bits(run(), A.grouped_sum(x.cpu(), layout)):
        raise AssertionError(f"K3 sum into {layout.num_groups} groups differs from its twin")
    ms = statistics.median(cuda_ms(run, 20))
    b2b = per_launch_ms(run)
    wrapper_ms = statistics.median(cuda_ms(lambda: A.grouped_sum(x, layout), 20))
    gids = torch.from_numpy(layout.group_ids.astype(np.int64)).to(dev)
    filled = x.nan_to_num(0.0)
    g, (rows, cols) = layout.num_groups, x.shape
    lib_ms = statistics.median(cuda_ms(
        lambda: torch.zeros((g, cols), device=dev).index_add_(0, gids, filled), 20))
    nbytes = (rows * cols + g * cols + pad.numel()) * 4
    members = int((layout.pad_index >= 0).sum(axis=1).max())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = members * CHAIN_CYCLES / clock_hz * 1e3
    return {"shape": f"[{rows}, {cols}]", "groups": g, "members": members,
            "wc": load_library("grouped_reduce").m3_grouped_reduce_width(g, cols), "ms": ms,
            "b2b": b2b, "wrapper_ms": wrapper_ms, "lib_ms": lib_ms, "bytes": nbytes,
            "bytes_ms": bytes_ms, "chain_ms": chain_ms, "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "operations"}


def device_us(fn, calls: int = 20) -> dict:
    """The profiler's device time a call of ``fn``, by device event (kernel,
    memset, copy), in microseconds: what the card spends, without the
    host's share of a single launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def fmt_us(by: dict) -> str:
    return ", ".join(f"{k.split('(')[0].split('::')[-1]} {v:.2f} us" for k, v in by.items())


def tsbs_host_tags(n_hosts: int, seed: int) -> list:
    """Each host's 10 TSBS devops tags, (name, value) bytes pairs sorted by
    name, drawn with numpy from ``seed`` over TSBS's value sets."""
    rng = np.random.default_rng(seed)
    regions = list(TSBS_REGIONS)
    reg = rng.integers(len(regions), size=n_hosts)
    dc_pick = rng.integers(1 << 30, size=n_hosts)
    picks = {k: rng.integers(len(v), size=n_hosts) for k, v in TSBS_CHOICES.items()}
    out = []
    for h in range(n_hosts):
        region = regions[reg[h]]
        dcs = TSBS_REGIONS[region]
        tags = {"hostname": f"host_{h}", "region": region, "datacenter": dcs[dc_pick[h] % len(dcs)]}
        tags.update({k: TSBS_CHOICES[k][picks[k][h]] for k in TSBS_CHOICES})
        out.append(tuple(sorted((k.encode(), v.encode()) for k, v in tags.items())))
    return out


def phase_index(dev, kernels: list, seed: int) -> None:
    """The inverted index at the TSBS devops cpu scale on the card."""
    import torch

    from m3_tpu_torch.index.device import DeviceIndexStore
    from m3_tpu_torch.index.device import batch as index_batch
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.index.device.segment import collect_leaves, match_rows
    from m3_tpu_torch.index.ns_index import NamespaceIndex
    from m3_tpu_torch.query.m3_storage import matchers_to_index_query
    from m3_tpu_torch.query.promql import Matcher

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hosts = tsbs_host_tags(INDEX_HOSTS, seed)
    store = DeviceIndexStore(device=dev)
    ix = NamespaceIndex(HOUR, device_store=store)
    for block, n_hosts in ((0, INDEX_HOSTS), (1, INDEX_SECOND_BLOCK_HOSTS)):
        ix.write_batch([(b"cpu_%s,host_%d" % (f.encode(), h),
                         ((b"__name__", b"cpu_" + f.encode()),) + hosts[h], T0 + block * HOUR)
                        for f in CPU_FIELDS for h in range(n_hosts)])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix.seal_before(T0 + 2 * HOUR)
    torch.cuda.synchronize()
    seal_s = time.perf_counter() - t0
    segs = [s for b in sorted(ix.blocks) for s in ix.blocks[b].segments]
    states = [s.status() for s in segs]
    if states != ["resident", "resident"]:
        raise AssertionError(f"index segments not resident: {states}")
    arrays = [s._arrays for s in segs]
    log(f"[index] TSBS devops cpu: {INDEX_HOSTS} hosts x {len(CPU_FIELDS)} fields = "
        f"{len(segs[0])} series + a second block of {len(segs[1])} (the first "
        f"{INDEX_SECOND_BLOCK_HOSTS} hosts), seed {seed}: host build {build_s:.2f} s, seal + "
        f"admission {seal_s:.2f} s; terms {[a.n_terms for a in arrays]}, key words "
        f"{[a.k_words for a in arrays]}, postings {[int(a.post_data.numel()) for a in arrays]}, "
        f"bitmap words {[a.n_words for a in arrays]}; device bytes {store.device_bytes()}")

    hosts8 = "|".join(f"host_{h}" for h in (3, 17, 42, 99, 1234, 20000, 54321, 99999))
    queries = {
        "single-groupby-1-1-1": [Matcher("__name__", "=", "cpu_usage_user"),
                                 Matcher("hostname", "=", "host_42")],
        "single-groupby-1-8-1": [Matcher("__name__", "=", "cpu_usage_user"),
                                 Matcher("hostname", "=~", hosts8)],
        "cpu-max-all": [Matcher("__name__", "=~", "cpu_.*")],
        "prefix-and-negation": [Matcher("region", "=~", "us-.*"), Matcher("service", "!=", "7")],
        "general-regexp": [Matcher("datacenter", "=~", ".*a")],
        "negated-prefix": [Matcher("hostname", "!~", "host_1.*")],
    }
    asts = {name: matchers_to_index_query(m) for name, m in queries.items()}
    span = (T0 - HOUR, T0 + 3 * HOUR)

    # the main path, counted: the six queries once, counts set to 0 just
    # before and read just after
    for k in IK.LAUNCHES:
        IK.LAUNCHES[k] = 0
    results = {name: ix.query(q, *span) for name, q in asts.items()}
    torch.cuda.synchronize()
    launches = dict(IK.LAUNCHES)
    log(f"[index] launches on the index path (6 queries over 2 resident segments): {launches}; "
        f"K2 {launches['bitmap_from_spans']} launches, at most one per segment and query "
        f"({len(asts) * len(segs)})")
    if launches["match_terms"] < 1 or launches["bitmap_from_spans"] < 1:
        raise AssertionError("the index path did not launch K1 and K2")
    if launches["bitmap_from_spans"] > len(asts) * len(segs):
        raise AssertionError("K2 launched more than once per segment and query")
    for name, q in asts.items():
        got = results[name].docs.ids()
        if got != ix.query(q, *span, force_host=True).docs.ids():
            raise AssertionError(f"[index] {name}: device doc ids differ from the host executor")
        log(f"[index] {name}: {len(got)} series, == host executor")
    st = store.stats()
    if st["search_misses"] or st["errors"] or [s.status() for s in segs] != states:
        raise AssertionError(f"[index] the store routed to the host or failed: {st}")
    log(f"[index] store: {st}")

    # K1 at the batched shape of query 2: both segments' keys, 9 leaves x 2
    keys, lens, bases, k_max = index_batch._combined(arrays)
    vals, lo, hi = [], [], []
    for si, a in enumerate(arrays):
        for field, value in collect_leaves(asts["single-groupby-1-8-1"])[0]:
            start, count = a.fields.get(field, (0, 0, 0, 0))[:2]
            vals.append(value)
            lo.append(int(bases[si]) + start)
            hi.append(int(bases[si]) + start + count)
    qk, ql = IK.build_query_keys(vals, k_max)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)

    k1_args = (keys, lens, up(np.asarray(lo, np.int32)), up(np.asarray(hi, np.int32)), up(qk),
               up(ql))
    k1_out = IK.match_terms(*k1_args)
    k1_ms = statistics.median(cuda_ms(lambda: IK.match_terms(*k1_args), 20))
    k1_b2b = per_launch_ms(lambda: IK.match_terms(*k1_args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k1_twin = IK.match_terms_reference(*k1_args)
    torch.cuda.synchronize()
    k1_plain = (time.perf_counter() - t0) * 1e3
    if not torch.equal(k1_out, k1_twin):
        raise AssertionError("K1 differs from its twin")
    lo_np, hi_np = np.asarray(lo, np.int32), np.asarray(hi, np.int32)
    if not np.array_equal(match_rows(keys, lens, lo_np, hi_np, vals, k_max, dev),
                          k1_twin.cpu().numpy()):
        raise AssertionError("match_rows differs from K1's twin")
    rows_times = []
    for _ in range(20):
        t0 = time.perf_counter()
        match_rows(keys, lens, lo_np, hi_np, vals, k_max, dev)
        rows_times.append((time.perf_counter() - t0) * 1e3)
    rows, n_keys = len(vals), int(keys.shape[0])
    # bytes: each row's key, length, bounds and result once, and the
    # log2(n) probed keys (k words + a length) of its search (the work a
    # search needs, whichever way it cuts the range)
    k1_bytes = rows * (k_max + 4) * 4 + rows * max(n_keys.bit_length(), 1) * (k_max + 1) * 4
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3

    # the launch floor: an empty kernel through the same route
    floor_ms = statistics.median(cuda_ms(lambda: IK.launch_floor(dev), 20))
    floor_b2b = per_launch_ms(lambda: IK.launch_floor(dev))

    # K2 at the path's largest leaf (cpu_.*: every posting of __name__ in
    # block 0, one span), and a term list of one term (query 1's __name__)
    a0 = arrays[0]
    name_start, _, ds, de = a0.fields[b"__name__"]
    range_spans = np.asarray([[0, ds, de]], np.int64)
    k2r = lambda: IK.bitmap_from_spans(a0.post_data, range_spans, 1, a0.n_words)
    k2r_out = k2r()
    k2r_again = k2r()
    k2r_ms = statistics.median(cuda_ms(k2r, 20))
    k2r_b2b = per_launch_ms(k2r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k2r_twin = IK.bitmap_from_term_range_reference(a0.post_data, ds, de, a0.n_words)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    gi = name_start + segs[0].terms(b"__name__").index(b"cpu_usage_user")
    cnt = int(a0.host_post_idx[gi, 1] - a0.host_post_idx[gi, 0])
    term_spans = np.column_stack([np.zeros(1, np.int64), IK.term_spans(a0.host_post_idx, [gi])])
    k2t = lambda: IK.bitmap_from_spans(a0.post_data, term_spans, 1, a0.n_words)
    k2t_out = k2t()
    k2t_ms = statistics.median(cuda_ms(k2t, 20))
    k2t_b2b = per_launch_ms(k2t)
    gis = torch.tensor([gi], dtype=torch.int32, device=dev)
    k2t_twin = IK.bitmap_from_terms_reference(a0.post_idx, a0.post_data, gis, a0.n_words)
    if not (torch.equal(k2r_out[0], k2r_twin) and torch.equal(k2r_out, k2r_again)
            and torch.equal(k2t_out[0], k2t_twin)):
        raise AssertionError("K2 differs from its twin, or between two runs")
    k2_bytes = (de - ds) * 4 + a0.n_words * 4
    k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
    k2t_bound = (cnt * 4 + a0.n_words * 4 + 12) / HBM_BYTES_PER_S * 1e3
    log(f"[index] launch floor (empty kernel, same route): {floor_ms:.4f} ms (median of 20 "
        f"single launches, CUDA events; back-to-back {floor_b2b:.4f} ms)")
    log(f"[index] K1 (match_terms, warp per row, 33-way) {rows} rows over {n_keys} keys x "
        f"{k_max} words: {k1_ms:.4f} ms (median of 20, CUDA events; back-to-back "
        f"{k1_b2b:.4f} ms); bound {k1_bound:.6f} ms ({k1_bytes} bytes at 3.35 TB/s), launch "
        f"floor {floor_ms:.4f} ms; twin {k1_plain:.2f} ms; match_rows (one pinned upload, K1, "
        f"one read back) {statistics.median(rows_times):.4f} ms (median of 20, host clock)")
    log(f"[index] K2 (bitmap_from_spans, range form) {de - ds} postings -> {a0.n_words} words: "
        f"{k2r_ms:.4f} ms (back-to-back {k2r_b2b:.4f} ms); bound {k2_bound:.6f} ms "
        f"({k2_bytes / 1e6:.3f} MB at 3.35 TB/s = {k2_bound / k2r_ms:.1%} of roofline), launch "
        f"floor {floor_ms:.4f} ms; twin {k2_plain:.2f} ms")
    log(f"[index] K2 (bitmap_from_spans, term-list form) one term of {cnt} postings: "
        f"{k2t_ms:.4f} ms (back-to-back {k2t_b2b:.4f} ms); bound {k2t_bound:.6f} ms, launch "
        f"floor {floor_ms:.4f} ms")
    log(f"[index] device time a call (torch.profiler, 20 calls): launch floor "
        f"{fmt_us(device_us(lambda: IK.launch_floor(dev)))}; K1 "
        f"{fmt_us(device_us(lambda: IK.match_terms(*k1_args)))}; K2 range form "
        f"{fmt_us(device_us(k2r))}; K2 term-list form {fmt_us(device_us(k2t))}")
    log("[index] library_ms: no single PyTorch call computes a multi-word lower-bound search "
        "(torch.searchsorted takes one scalar key a row) or a packed doc bitmap; null")

    for name, q in asts.items():
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            len(ix.query(q, *span).docs)
            times.append(time.perf_counter() - t0)
        log(f"[index] end to end {name}: {statistics.median(times) * 1e3:.3f} ms (median of 10, "
            f"host clock, NamespaceIndex.query over both blocks to the matched docs)")
    log(f"[index] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    kernels += [{
        "name": "index_match_terms",
        "route": "cuda",
        "source": "m3_tpu_torch/index/device/csrc/index_kernels.cu",
        "replaces": "m3_tpu/index/device/kernels.py:133",
        "launches": launches["match_terms"],
        "max_abs_err": 0,
        "ms": k1_ms,
        "plain_ms": k1_plain,
        "bound_ms": k1_bound,
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": floor_ms,
    }, {
        "name": "index_bitmap",
        "route": "cuda",
        "source": "m3_tpu_torch/index/device/csrc/index_kernels.cu",
        "replaces": "m3_tpu/index/device/kernels.py:269",
        "launches": launches["bitmap_from_spans"],
        "max_abs_err": 0,
        "ms": k2r_ms,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound,
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": floor_ms,
    }]


def subnormal_values(n_series: int, steps: int, seed: int) -> np.ndarray:
    """f32 values whose inputs, sums, means and squared deviations are
    subnormal, with +-0 and NaN mixed in (K3's flush check)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n_series, steps)) * 1e-37).astype(np.float32)
    roll = rng.random(v.shape)
    v[roll < 0.2] = np.float32(1e-40)
    v[(roll >= 0.2) & (roll < 0.35)] = np.float32(-3e-40)
    v[(roll >= 0.35) & (roll < 0.45)] = np.nan
    v[(roll >= 0.45) & (roll < 0.55)] = -0.0
    v[(roll >= 0.55) & (roll < 0.6)] = 0.0
    return v


def tiled_packed_scan(streams: list[bytes], n_series: int, k: int, dev):
    """What ``streamed_scan_totals`` gives for ``n_series`` series, series j
    holding ``streams[j % len(streams)]``, with the same padding: the unique
    streams prescanned once and their lanes gathered on the host."""
    from m3_tpu_torch.ops import fused
    from m3_tpu_torch.ops.chunked import build_chunked, select_series
    from m3_tpu_torch.parallel.scan import chunked_scan_aggregate_packed
    from m3_tpu_torch.resident.scan import _MIN_LANES, _pow2

    u = len(streams)
    s_pad = _pow2(n_series, _MIN_LANES)
    batch = select_series(build_chunked(list(streams) + [b""], k=k),
                          np.concatenate([np.arange(n_series) % u, np.full(s_pad - n_series, u)]))
    packed = fused.pack_lanes(batch, device=dev)
    return chunked_scan_aggregate_packed(packed, s=s_pad, c=batch.num_chunks, k=k)


def phase_database(dev, kernels: list, b2_resident: dict) -> None:
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from m3_tpu_torch.block.core import SeriesMeta, make_tags
    from m3_tpu_torch.index.device import IndexDeviceOptions
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.ops.sideplane import pack_side_rows
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.query import engine as E
    from m3_tpu_torch.query import stats
    from m3_tpu_torch.query.functions import aggregation as A
    from m3_tpu_torch.query.functions import temporal_fused as TF
    from m3_tpu_torch.query.m3_storage import BlockStorage, M3Storage, matchers_to_index_query
    from m3_tpu_torch.query.promql import Matcher
    from m3_tpu_torch.resident import ResidentOptions
    from m3_tpu_torch.resident.scan import _M_STREAMED_BYTES
    from m3_tpu_torch.storage.database import Database, NamespaceOptions
    from m3_tpu_torch.storage.fs import CHUNK_K, FilesetID, write_fileset
    from m3_tpu_torch.utils.hash import shard_for
    from m3_tpu_torch.utils.serialize import encode_tags
    from m3_tpu_torch.utils.synthetic import synthetic_streams

    s = DB_SERIES
    b0 = T0 // BLOCK * BLOCK
    b1 = b0 + BLOCK
    torch.cuda.reset_peak_memory_stats()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    base = tempfile.mkdtemp(prefix="chip_smoke_db-", dir=root)
    try:
        # 1. bulk: the block's filesets, written directly (72M points through
        # write_batch in Python would take minutes); side rows computed once
        # per unique stream. The index returns a shard's series in id order,
        # shard after shard; the series at place j of that order holds
        # stream j % N_UNIQUE, so the references below (BlockStorage, the
        # packed scan) tile the unique streams in the order M3Storage reads
        # the series instead of prescanning 100,000 streams
        t0 = time.perf_counter()
        streams = synthetic_streams(N_UNIQUE, N_POINTS, seed=3, start_nanos=b0)
        side = [pack_side_rows(chunked.snapshot_stream(x, CHUNK_K), b0) for x in streams]
        if any(r is None for r in side):
            raise AssertionError("a unique stream's side rows overflow the packed layout")
        tags = [make_tags({"__name__": "m3_scan", "job": f"job-{i % QUERY_JOBS}", "host": f"h{i}"})
                for i in range(s)]
        sids = [encode_tags(t) for t in tags]
        want_order = sorted(range(s), key=lambda i: (shard_for(sids[i], DB_SHARDS), sids[i]))
        stream_of = np.empty(s, np.int64)
        stream_of[want_order] = np.arange(s) % N_UNIQUE
        per_shard = [({}, {}) for _ in range(DB_SHARDS)]
        for i, sid in enumerate(sids):
            data, rows = per_shard[shard_for(sid, DB_SHARDS)]
            data[sid] = streams[stream_of[i]]
            rows[sid] = side[stream_of[i]]
        for sh, (data, rows) in enumerate(per_shard):
            write_fileset(base, FilesetID("m3", sh, b0, 0), data, BLOCK, CHUNK_K, side_rows=rows)
        bulk_s = time.perf_counter() - t0

        def open_db():
            db = Database(base, num_shards=DB_SHARDS,
                          resident_options=ResidentOptions(max_bytes=1 << 30),
                          index_device_options=IndexDeviceOptions(), device=dev)
            db.create_namespace("m3", NamespaceOptions())
            return db

        # bootstrap: filesystem source, the re-index, _readmit_resident
        db = open_db()
        t0 = time.perf_counter()
        boot = db.bootstrap(now_nanos=b1 + BLOCK)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        rst = db.resident_stats()
        if (boot["filesets"] != DB_SHARDS or boot["sources"]["m3"]["fulfilled"]["filesystem"]
                != DB_SHARDS or rst["entries"] != s or rst["complete_blocks"] != DB_SHARDS):
            raise AssertionError(f"[database] bootstrap: {boot}, resident {rst}")
        log(f"[database] bulk: {s} series x {N_POINTS} pts ({N_UNIQUE} unique gauge streams, "
            f"seed 3, one {BLOCK // 10**9} s block) as {DB_SHARDS} filesets in {bulk_s:.2f} s; "
            f"bootstrap {boot_s:.2f} s: {boot['filesets']} filesets, sources "
            f"{boot['sources']['m3']['fulfilled']}, {rst['entries']} lanes admitted "
            f"({rst['bytes']} stream bytes, {rst['complete_blocks']} complete blocks)")

        # 2. live writes into the next block: buffers and the commit log.
        # The streamed scans read the live series only, h0 .. h{L-1}: a
        # streamed series pays its host prescan in Python (PERF.md), so a
        # streamed scan of the whole block would take minutes
        m_all = [Matcher("__name__", "=", "m3_scan")]
        digits = len(str(DB_LIVE_SERIES - 1))
        if DB_LIVE_SERIES != 10 ** digits:
            raise ValueError("DB_LIVE_SERIES must be a power of ten (the live slice's regexp)")
        m_live = m_all + [Matcher("host", "=~", f"h[0-9]{{1,{digits}}}")]
        st = M3Storage(db, "m3")
        live = [(tags[i], b1 + j * STEP, float(round((i % 97) * 0.5 + j * 0.25, 2)), 1)
                for i in range(DB_LIVE_SERIES) for j in range(DB_LIVE_POINTS)]
        t0 = time.perf_counter()
        errs = db.write_tagged_batch("m3", live)
        live_s = time.perf_counter() - t0
        if any(errs):
            raise AssertionError(f"[database] live writes refused: {[e for e in errs if e][:3]}")
        qs = stats.start("both blocks")
        qs.record_routing = True
        t0 = time.perf_counter()
        both = st.scan_totals(m_live, b0, b1 + BLOCK)
        both_s = time.perf_counter() - t0
        stats.finish(qs, 0.0)
        if both["path"] != "streamed" or not any(
                r["reason"] == "buffered-overlay" for r in qs.routing):
            raise AssertionError(f"[database] a scan over the buffered block: {both}, "
                                 f"{qs.routing[:3]}")
        if both["count"] != DB_LIVE_SERIES * (N_POINTS + DB_LIVE_POINTS):
            raise AssertionError(f"[database] scan over both blocks counted {both['count']}")
        t0 = time.perf_counter()
        flushed = db.flush("m3", b1 + BLOCK)
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
        rst = db.resident_stats()
        if len(flushed) != DB_SHARDS or rst["entries"] != s + DB_LIVE_SERIES:
            raise AssertionError(f"[database] flush of the live block: {flushed}, {rst}")
        log(f"[database] live: write_tagged_batch of {DB_LIVE_SERIES} series x {DB_LIVE_POINTS} "
            f"pts into the next block {live_s:.2f} s; scan_totals of those series over both blocks "
            f"routed streamed (buffered-overlay) {both_s:.2f} s, count {both['count']}; flush of that "
            f"block {flush_s:.2f} s, {len(flushed)} filesets admitted at seal "
            f"({rst['entries']} lanes resident)")

        # 3. queries through Engine over M3Storage (the staged path), each
        # held bit for bit to the same query over BlockStorage on the same
        # streams in the same series order
        docs = db.query_ids("m3", matchers_to_index_query(m_all), b0, b0 + BLOCK).docs
        index_of = {sid: i for i, sid in enumerate(sids)}
        order = [index_of[d.id] for d in docs]
        if order != want_order:
            raise AssertionError("[database] the index does not return every series once, "
                                 "shard after shard in id order")
        bstore = BlockStorage(streams, [tags[i] for i in order], k=K, device=dev)
        eng = E.Engine(st, device=dev)
        beng = E.Engine(bstore, device=dev)
        start, end = b0, b0 + (N_POINTS - 1) * STEP
        queries = {"rate": "sum by (job) (rate(m3_scan[1m]))",
                   "avg_over_time": "avg by (job) (avg_over_time(m3_scan[1m]))"}
        # the main path, counted: both queries and a resident scan, the
        # counts set to 0 just before and read just after
        chunked.LAUNCHES = fused.LAUNCHES = TF.LAUNCHES = A.LAUNCHES = scan.ASSEMBLY_LAUNCHES = 0
        for k in IK.LAUNCHES:
            IK.LAUNCHES[k] = 0
        results = {fn: eng.query_range(q, start, end, STEP) for fn, q in queries.items()}
        resident = st.scan_totals(m_all, b0, b0 + BLOCK)
        torch.cuda.synchronize()
        launches = {"resident_assembly": scan.ASSEMBLY_LAUNCHES, "decode_records": chunked.LAUNCHES,
                    "lane_aggregates": fused.LAUNCHES, "temporal_fused": TF.LAUNCHES,
                    "grouped_reduce": A.LAUNCHES, "index_match_terms": IK.LAUNCHES["match_terms"],
                    "index_bitmap": IK.LAUNCHES["bitmap_from_spans"]}
        log(f"[database] launches on the main path (2 queries, 1 scan): {launches}")
        for name, n in launches.items():
            if n < 1:
                raise AssertionError(f"the [database] path did not launch {name}")
        for fn, q in queries.items():
            want = beng.query_range(q, start, end, STEP)
            got = results[fn]
            if ([m.tags for m in got.metas] != [m.tags for m in want.metas]
                    or not same_bits(got.values, want.values)):
                raise AssertionError(f"[database] {q} over M3Storage differs from BlockStorage")
            if not same_bits(eng.query_range(q, start, end, STEP).values, got.values):
                raise AssertionError(f"[database] {q}: a second run differs from the first")
        log(f"[database] both queries over M3Storage == the same queries over BlockStorage bit "
            f"for bit ([{len(results['rate'].metas)}, {results['rate'].values.shape[1]}]), and "
            f"== a second run")
        e2e = {}
        for fn, q in queries.items():
            times = []
            for _ in range(DB_QUERY_RUNS):
                t0 = time.perf_counter()
                eng.query_range(q, start, end, STEP).values.cpu()
                times.append(time.perf_counter() - t0)
            e2e[fn] = statistics.median(times)

        # scan_totals: resident == chunked_scan_aggregate_packed over the
        # same streams in the same order and padding (the streamed twin)
        if resident["path"] != "resident" or resident["series"] != s:
            raise AssertionError(f"[database] scan_totals of the bulk block: {resident}")
        want = tiled_packed_scan(streams, s, CHUNK_K, dev)
        want_t = {"sum": float(want.total_sum), "count": int(want.total_count),
                  "min": float(want.total_min), "max": float(want.total_max)}
        if {k: resident[k] for k in want_t} != want_t:
            raise AssertionError(f"[database] resident scan {resident} != packed scan {want_t}")
        up = (db.resident_stats()["upload_bytes"], _M_STREAMED_BYTES.value)
        res_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            warm = st.scan_totals(m_all, b0, b0 + BLOCK)
            res_s.append(time.perf_counter() - t0)
            if warm != resident:
                raise AssertionError(f"[database] warm scan {warm} != {resident}")
        if (db.resident_stats()["upload_bytes"], _M_STREAMED_BYTES.value) != up:
            raise AssertionError("[database] a warm resident scan moved upload bytes")
        log(f"[database] scan_totals path resident == chunked_scan_aggregate_packed over the same "
            f"streams bit for bit (count {resident['count']}, sum {resident['sum']!r}); 3 warm "
            f"repeats moved 0 upload bytes")

        # 4. eviction churn over the live slice: streamed with the same bits,
        # read-through re-admission, resident again (and so is the block)
        res_live = st.scan_totals(m_live, b0, b0 + BLOCK)
        if res_live["path"] != "resident" or res_live["series"] != DB_LIVE_SERIES:
            raise AssertionError(f"[database] scan_totals of the live slice: {res_live}")
        readmitted = db.resident_stats()["readmissions"]
        dropped = db.resident_clear()
        t0 = time.perf_counter()
        churn = st.scan_totals(m_live, b0, b0 + BLOCK)
        streamed_s = time.perf_counter() - t0
        back = st.scan_totals(m_live, b0, b0 + BLOCK)
        n_readmit = db.resident_stats()["readmissions"] - readmitted
        full = st.scan_totals(m_all, b0, b0 + BLOCK)
        if (churn != {**res_live, "path": "streamed"} or back != res_live or full != resident
                or n_readmit != s):
            raise AssertionError(f"[database] churn: {churn}, then {back}, {n_readmit} re-admitted, "
                                 f"the block {full}")
        # the streamed path's host cost: each series' prescan in Python
        live_streams = [streams[stream_of[i]] for i in range(DB_LIVE_SERIES)]
        t0 = time.perf_counter()
        chunked.build_chunked(live_streams, k=CHUNK_K)
        prescan_s = time.perf_counter() - t0
        log(f"[database] eviction churn: resident_clear dropped {dropped}; the next scan of the "
            f"{DB_LIVE_SERIES} live series streamed with the same totals bit for bit, {n_readmit} "
            f"lanes re-admitted read-through, the scan after it resident again, and so is the "
            f"scan of the block; the prescan alone (build_chunked, Python) of those "
            f"{DB_LIVE_SERIES} streams {prescan_s * 1e3:.1f} ms, "
            f"{prescan_s / DB_LIVE_SERIES * 1e3:.3f} ms a series")

        # 5. kernel checks at this shape: B-2 over the bulk block's plan, K3
        # on subnormal inputs against its flushed twin
        pool = db.resident_pool
        plan_keys = [key for _, keys in st._resident_plan(docs, b0, b0 + BLOCK) for key in keys]
        with pool.read_lease():
            plan = pool.plan_chunked(plan_keys)
        b2 = b2_check(plan, 1 << (s - 1).bit_length(), "database")
        sub = torch.from_numpy(subnormal_values(2 * QUERY_JOBS * 50, N_POINTS, seed=7)).to(dev)
        layout = A.group_by_tags([SeriesMeta(tags=tags[i]) for i in range(sub.shape[0])], [b"job"])
        for op in A.OPS:
            if not same_bits(A.grouped_reduce(sub, layout, op),
                             A.grouped_reduce(sub.cpu(), layout, op)):
                raise AssertionError(f"[database] K3 {op} on subnormal inputs differs from its twin")
        log(f"[database] K3 on subnormal, +-0 and NaN inputs [{sub.shape[0]}, {sub.shape[1]}] "
            f"-> {layout.num_groups} groups == its flushed twin bit for bit: {', '.join(A.OPS)}")

        # 6. restart: every acknowledged live write reads back, the sealed
        # blocks are resident again
        db.close()
        db = open_db()
        t0 = time.perf_counter()
        boot2 = db.bootstrap(now_nanos=b1 + BLOCK)
        torch.cuda.synchronize()
        boot2_s = time.perf_counter() - t0
        want_t = np.asarray([b1 + j * STEP for j in range(DB_LIVE_POINTS)], np.int64)
        for i in range(DB_LIVE_SERIES):
            t, v, _u = db.read_arrays("m3", sids[i], b1, b1 + BLOCK)
            want_v = np.asarray([round((i % 97) * 0.5 + j * 0.25, 2) for j in range(DB_LIVE_POINTS)])
            if not (np.array_equal(t, want_t) and np.array_equal(v, want_v)):
                raise AssertionError(f"[database] live series {i} did not read back after restart")
        rst = db.resident_stats()
        again = M3Storage(db, "m3").scan_totals(m_all, b0, b0 + BLOCK)
        if rst["entries"] != s + DB_LIVE_SERIES or again != resident:
            raise AssertionError(f"[database] after restart: {rst}, {again}")
        log(f"[database] restart: bootstrap {boot2_s:.2f} s ({boot2['filesets']} filesets, "
            f"{boot2['commitlog_entries']} commit-log entries replayed); all "
            f"{DB_LIVE_SERIES * DB_LIVE_POINTS} acknowledged live writes read back equal; "
            f"{rst['entries']} lanes resident, scan_totals resident and equal")
        istats = db.index_stats()
        log(f"[database] resident stats: { {k: rst[k] for k in ('entries', 'bytes', 'pages_used', 'side_pages_used', 'complete_blocks', 'admissions', 'readmissions', 'evictions', 'invalidations', 'upload_bytes')} }")
        log(f"[database] index stats: { {k: v for k, v in istats.items() if k != 'namespaces'} }, "
            f"namespace m3: {istats['namespaces']['m3']}")
        for fn, q in queries.items():
            log(f"[database] end to end {q} over M3Storage: {e2e[fn] * 1e3:.1f} ms (median of "
                f"{DB_QUERY_RUNS}, host clock, ending in a host copy)")
        log(f"[database] end to end scan_totals of m3_scan over {s} series: resident "
            f"{statistics.median(res_s) * 1e3:.1f} ms (median of 3); streamed over the "
            f"{DB_LIVE_SERIES} live series {streamed_s * 1e3:.1f} ms (one run, the re-admission "
            f"of {n_readmit} lanes included), over both blocks {both_s * 1e3:.1f} ms (one run)")
        log(f"[database] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        db.close()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    check_no_unaligned_copies("database")
    kernels.append({
        "name": "resident_assembly",
        "route": "cuda",
        "source": "m3_tpu_torch/parallel/csrc/resident_assembly.cu",
        "replaces": "m3_tpu/parallel/scan.py:505",
        "launches": launches["resident_assembly"],
        "max_abs_err": 0.0,
        "ms": b2_resident["ms"],
        "plain_ms": b2_resident["plain_ms"],
        "bound_ms": b2_resident["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    })
    log(f"[database] B-2 at [database]'s shape: {b2['ms']:.3f} ms (bound {b2['bound_ms']:.3f} ms, "
        f"twin {b2['plain_ms']:.1f} ms); the kernels line carries [resident]'s 1M-series "
        f"numbers: {b2_resident['ms']:.3f} ms (bound {b2_resident['bound_ms']:.3f} ms, twin "
        f"{b2_resident['plain_ms']:.1f} ms)")
    log("[database] library_ms for B-2: no single PyTorch call gathers M3TSZ windows and "
        "unpacks side planes; null")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED, help="seed of the [index] phase's tags")
    args = ap.parse_args()

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
    b2 = phase_resident(dev, kernels, b3_worst, main_e2e_s)
    phase_records(dev)
    temporal_err = phase_temporal(dev)
    temporal_err = max(temporal_err, phase_temporal_sizes(dev))
    phase_query(dev, kernels, temporal_err)
    phase_index(dev, kernels, args.seed)
    phase_database(dev, kernels, b2)

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
