"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  build  — compile the lane-aggregate kernel from ops/csrc with nvcc.
  parity — kernel vs its plain PyTorch twin, per lane, on gauge, counter,
           float, mixed and special-value batches (4,096 series x 720
           points, k=24): count and err exact, sum/min/max/last
           bit-identical with NaN in the same places.
  main   — the scan-and-aggregate path at 1,048,576 series x 720 points,
           k=24, 64 unique gauge streams, seed 3: synthetic_streams ->
           build_chunked -> pack_lanes (tiled on the card) ->
           chunked_scan_aggregate_packed. total_count must equal the host
           decode exactly, total_sum within rtol 1e-3. Then the kernel's
           warm time (CUDA events), the end-to-end rate, the twin's time
           and a per-lane kernel-vs-twin check at this shape.
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PARITY_SERIES, MAIN_SERIES, N_POINTS, K, N_UNIQUE = 4096, 1 << 20, 720, 24, 64
T0 = 1_600_000_000 * 10**9
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


def needed_bytes(streams, packed, n_series: int, k: int) -> dict:
    """Bytes the main path's lane function must move, each read or write
    once: for every real lane the window words its chunk's bits occupy,
    the state planes its tile's body reads (general 17, int-fast 5,
    float-fast 6), the tile flags, and 21 bytes of aggregates written.
    Chunk-major lanes (order "c"), series i tiling unique series i % S."""
    import torch

    from m3_tpu_torch.ops.chunked import snapshot_stream

    cw, npad = packed.windows.shape
    s_u = len(streams)
    c = packed.n // n_series
    words_u = np.zeros((s_u, c), np.int64)
    for si, data in enumerate(streams):
        for ci, p in enumerate(snapshot_stream(data, k)):
            if p["span"] > 0:
                words_u[si, ci] = min(cw, -(-((p["off"] & 31) + p["span"]) // 32))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from m3_tpu_torch.codec.m3tsz import decode, encode_series
    from m3_tpu_torch.ops import _build, fused
    from m3_tpu_torch.ops.chunked import build_chunked
    from m3_tpu_torch.parallel.scan import chunked_scan_aggregate_packed
    from m3_tpu_torch.utils.synthetic import synthetic_mixed_streams, synthetic_streams

    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")

    # --- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] lane_aggregates.cu built+loaded in {time.perf_counter() - t0:.2f}s")
    log(_build.BUILD_LOG.strip())

    # --- parity: kernel vs twin per lane on five batch kinds ---------------
    worst = 0.0
    # mixed: sorted series and 8-row tiles, so all three bodies get tiles;
    # specials: NaN, infinities, signed zeros and subnormals (FTZ, NaN-aware
    # min/max) after a first value of 0.5
    for kind, order, rows in (("gauge", "c", 32), ("counter", "c", 32), ("float", "c", 32),
                              ("mixed", "sorted", 8), ("specials", "c", 32)):
        if kind == "mixed":
            streams = synthetic_mixed_streams(N_UNIQUE, N_POINTS, seed=5, frac_float=0.5)
        elif kind == "specials":
            streams = [encode_series(
                [T0 + j * 10**9 for j in range(N_POINTS)],
                [0.5] + [SPECIALS[(j * 7 + i) % len(SPECIALS)] for j in range(N_POINTS - 1)],
            ) for i in range(16)]
        else:
            streams = synthetic_streams(N_UNIQUE, N_POINTS, seed=3, kind=kind)
        batch = build_chunked(streams, k=K)
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

    # --- main path ---------------------------------------------------------
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
    log(f"[main] kernel warm median {kernel_ms:.3f} ms (20 launches, CUDA events); "
        f"bound {bound_ms:.3f} ms ({bytes_moved / 1e9:.3f} GB at 3.35 TB/s = "
        f"{bound_ms / kernel_ms:.1%} of roofline; f32 ops "
        f"{ops_ms:.4f} ms); twin {plain_ms:.1f} ms; end to end {e2e_med * 1e3:.3f} ms = "
        f"{total_count / e2e_med:.4e} datapoints/s; max_abs_err {worst!r}")
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("[main] library_ms: no single PyTorch call computes an M3TSZ decode; null")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kernels = [{
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
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
