"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N] [--parent-b1 TREE/m3_tpu_torch/query/csrc/consolidate_grid.cu]
        [--parent-b7 TREE/m3_tpu_torch/query/functions/csrc/temporal_window.cu]
        [--parent-b5 TREE/m3_tpu_torch/aggregator/csrc/rollup.cu]
        [--parent-b4 TREE/m3_tpu_torch/ops/csrc/encode.cu]
        [--parent-b6 TREE/m3_tpu_torch/ops/csrc/lane_aggregates.cu]
        [--parent-scan TREE/m3_tpu_torch/parallel/scan.py]

Phases (any failure exits non-zero):
  build    — compile the kernel libraries from their csrc/ sources with
             nvcc and the host codec library (m3_tpu_torch/native/m3tsz.cc)
             with g++, one process per source, all started together.
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
             and a per-lane kernel-vs-twin check at this shape. With
             --parent-scan (another tree's parallel/scan.py) the scan's
             reductions and the scan end to end are timed in turns with
             that tree's reductions (parent, new, new, parent).
  batched  — the whole-stream decode (kernel B-6) vs its twin on the card,
             every field bit for bit (values_f32 with NaN in the same
             places), in both int_optimized modes on 4,096 series tiling
             the unique streams of every parity kind and of a
             synthetic_mixed_streams set (unit changes, annotations: err
             series). Then scan_aggregate over tiled_batch(1,048,576, 720)
             (the 64 gauge streams of seed 3): per-series count, min, max,
             last, sum and err == chunked_scan_aggregate (kernel R) of the
             same streams bit for bit, B-6 timed (CUDA events) beside its
             bytes bound (the words each stream's bits occupy, 23 bytes a
             record), end to end beside [main]'s chunked scan, with the
             peak device memory; then B-6 == its twin on the scan's own
             inputs, every field bit for bit, and the twin's time there;
             B-6's launch shape (warps, blocks, shared memory, registers,
             ptxas) and the launch floor. With --parent-b6 (another tree's
             ops/csrc/lane_aggregates.cu) that tree's B-6 is built beside
             this one and timed in turns with it (parent, new, new, parent)
             on the scan's inputs, outputs equal bit for bit.
  mesh     — an NCCL world of one (init_process_group with a FileStore
             under build/, no TCP): resident_scan_totals(mesh=) ==
             mesh=None at [resident]'s 1M series (checked inside
             [resident], which holds the pool), make_sharded_scan ==
             scan_aggregate and make_sharded_chunked_scan ==
             chunked_scan_aggregate at 1,048,576 x 720, bit for bit; the
             all-reduce's ms. The group is destroyed at the end.
  stream   — stream_aggregate over 16 batches of 65,536 series x 720
             (k=24, bench_stream.py's batch), each batch of other streams
             (64 unique gauge streams of seed 3 + b, tiled), with two in
             flight, pinned uploads on a side stream: count, min and max ==
             the fold of each batch's own packed scan and sum within rtol
             1e-6; wall seconds, points/s, the
             steady-state drain interval, upload GB/s and B1 a batch. Then
             the fileset route: one fileset of 100,000 series x 720
             (series i holds unique stream i % 64 of seed 5, from the
             native encoder; side rows computed once a unique stream) read
             in batches straight off its side tables == the same batches
             prescanned from the streams (count exact, sum within rtol
             1e-6).
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
             (window 7): kernel R decodes, kernel B-1 consolidates. The grid
             of the unique rows must equal the host decode +
             consolidate_row bit for bit, and each job's result the
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
             group, with the column-block width it picked. B-1 is held to
             its twin bit for bit (values and counts) at the query's shape
             ([100,000, 720] -> [100,000, 726], [database]'s too) and at a
             ragged [333, 517] -> [333, 301], and timed single and back to
             back beside its bytes bound, the twin and the launch floor (an
             empty kernel through the same route), with its launch shape
             (warps a block, blocks, shared memory, registers) and ptxas's
             report. With --parent-b1 (another tree's consolidate_grid.cu)
             that tree's B-1 is built beside this one and timed in turns
             with it (parent, new, new, parent) on the same inputs.
  promql   — the rest of PromQL over [query]'s BlockStorage (the same
             100,000 series, 10 s step): predict_linear(m3_scan[1h], 14400)
             < 0, deriv(m3_scan[5m]), holt_winters(m3_scan[10m], 0.3, 0.6)
             and quantile_over_time(0.99, m3_scan[5m]) (kernel B-7 at W =
             361, 31, 61, 31), a many-to-one ratio (group_left), topk and
             quantile by (job), a subquery and @ end(). B-7 must launch once
             a query. Each query's result equals Engine(device="cpu") over a
             CPU copy of the card's fetched grid (metas, dtype, NaN pattern,
             values within 1e-4 abs + rel): on all 100,000 series, but the
             predict_linear and holt_winters queries on the fan-out
             matcher's 11,111 (their twins take over a minute on the CPU at
             100,000 series). Then each query's host
             time end to end (median of 10) and device time (torch.profiler),
             and B-7 as the engine calls it (the kept columns, first = W - 1)
             == its twin sliced at first on the card bit for bit on every row
             at each window, timed single and back to back beside its bound
             (max of the bytes, the input read once and the kept columns
             written once, and its f32 operations over the kept windows'
             valid slots, B7_OPS: 3 a slot of the linear functions where the
             window holds its samples in one run at its end, 7 elsewhere,
             and the slope's 7 (predict_linear's 13) a window; 8n - 11 for
             holt_winters), the no-FMA ceiling (half the f32 rate),
             its launch shape, the twin and, for the quantile,
             unfold(...).nanquantile and the quantile's time at runs of 23,
             45, 90 and 180 columns a lane; and the quantile at W = 361 on
             the predict_linear grid and on it with every window full, at
             the kernel's layout and at runs of 23 to 360 columns a lane.
             With --parent-b7 (another tree's
             temporal_window.cu, whose entry computes every column) that
             tree's B-7 is built beside this one and timed in turns with it
             (parent, new, new, parent) on each input, and the four B-7
             queries run end to end in turns with each (new, parent,
             parent, new).
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
             overlay); the flush of that block admits at seal. Engine over
             M3Storage runs sum by (job) (rate(m3_scan[1m])) and avg by (job)
             (avg_over_time(m3_scan[1m])) through the query plan (the first
             builds it; plan hits or misses, 0 fallbacks, 0 plan errors,
             each query's routing printed), each bit-identical, values and
             metas, to the same query force-staged (one run each, timed), to
             the same query over BlockStorage on the same streams and to a
             second run; then the warm median of 10, a warm query's launches
             by kernel and its device-to-host copies (torch.profiler: must be
             1); scan_totals is
             resident and bit-identical to chunked_scan_aggregate_packed over
             the same streams, and warm repeats move 0 upload bytes. After
             resident_clear a scan of the 1,000 live series streams with the
             same bits, read-through re-admission brings every lane back, and
             the next scans are resident. The streamed scans read that slice
             only: each streamed series pays its host prescan (the host codec
             library's, and its lanes' assembly), timed on its own. Restart: close, a new Database over the directory,
             bootstrap; every acknowledged live write reads back equal and
             the sealed blocks are resident again. Kernel B-2 == its twin bit
             for bit here and in [resident] (1M series), K3 on subnormal
             inputs == its flushed twin. Prints the bootstrap seconds, each
             query's cold, warm and force-staged times, the scans' end-to-end
             times, B-2's
             time beside its bound, its twin's and the series its direct
             route took, and the node's resident and index stats.
  admission — on [database]'s node after its restart (no new data):
             Engine(M3Storage, scheduler=QueryScheduler(max_inflight=2,
             max_queue=8), tenant_enforcers=TenantEnforcers(noisy:
             max_series=1,000)) on the card, 12 threads under the tenants
             alpha, beta and noisy, each issuing [database]'s two warm
             plan-served queries 6 times, with every kernel profiler at
             sample_rate 1 and a StackSampler at default_hz(). Each outcome
             is the plain engine's result bit for bit, a QueryLimitError
             (noisy only) or a QueryShedError with a reason of the
             vocabulary; the ledger's queries, limit rejections and sheds and
             m3tpu_query_shed_total by reason equal what the threads saw;
             the scheduler ends with 0 in flight; each record's
             device_dispatches is its one query_plan dispatch (0 when
             coalesced) plus B2's temporal_fused one; the tenants'
             decode_seconds sum to the change in the kernel_dispatch_seconds
             histograms' sums. Prints per kernel the sampled dispatches'
             count and median seconds beside their CUDA-event ms, a warm
             query's latency at sample_rate 0 and 1 in turns,
             collect_device_memory(db) (checked against the pool and the
             index) beside torch.cuda.max_memory_allocated(), and the
             sampler's samples, share in the query path and errors (0).
  hostcodec — the host codec library (m3_tpu_torch/native/, the copy of
             the JAX package's C++ codec under every host path of the storage
             node, residency and the chunked lanes) at BASELINE config 3's
             scale: [ingest]'s generator (seed 21), 100,000 series x 720
             points. encode_batch, prescan_batch at k=24 (the C++ call and the
             snapshot dicts timed apart), decode_batch (max_points 720) and
             shard_batch (100,000 ids into 8 shards), each timed with its
             series/s; every series decodes to its input times (and the int
             lanes to their values). On the first 200 series the port's
             Python codec runs the same calls, timed: stream bytes, snapshot
             fields, triples (bit for bit) and shard ids must be identical.
  ingest   — the write path. B-4 (the batched M3TSZ encode) at the seal of
             BASELINE config 3's node: 100,000 lanes x 720 points (the 2 h
             block at 10 s) from bench_suite.py's encode generator (seed 21:
             times T0 + cumsum(integers(1, 30)) s, odd lanes int values in
             [-5000, 5000), even lanes normal(0, 10)), classified by
             classify_lanes, packed by pack_lanes and moved to the card by
             upload_lanes (page_words 512);
             B-4 == its twin on the card bit for bit on every output of every
             lane, the first 256 lanes' streams == the host codec's
             encode_series; its C entry into outputs filled with -1 gives
             the same (every word of the rows written); B-4 timed (CUDA
             events, median of 10, back to back) beside its bytes bound (the
             records read once, the whole [M, W] rows, zeros included, and
             the chunk tables written once), the launch floor and the twin,
             with its launch shape (warps a block, blocks, shared memory,
             registers and spills as ptxas reported them) and the host
             seconds of the classification and the packing. With
             --parent-b4 (another tree's encode.cu) that tree's B-4 is built
             beside this one and timed in turns with it (parent, new, new,
             parent) on the same planes, outputs equal bit for bit. Then two storage nodes on the
             card (8 shards, residency on, commit log on), one with
             ingest_options=IngestOptions() (the device seal) and one
             without (the host seal), each taking the same write_batch of
             1,000 series x 720 points at 10 s into one block (a series in
             ten mixes int and float values: host-fallback lanes; one in
             fifty has an out-of-order point: a dirty lane) and flushing it:
             every fileset file byte-identical, every series reads back equal
             on both, the device node admits every eligible lane born
             resident (device_admissions), the same admissions as the host
             node, upload bytes only for the fallback lanes' pages and below
             the host node's, no ingest spill; B-4 launched on the device
             node's flush. Prints the write and flush seconds and the seal's
             host seconds by stage (classify, packing, encode, side rows,
             streams, fileset write, admission) for both nodes.
  aggregator — the aggregator tier at BASELINE config 4 (10,000,000 active
             series, 10 s points rolled up into 1 m windows): the datapoints
             as bench_suite.py builds them (6 a series, lognormal values,
             seed 2) densified on the host (window_keys + pack_dense_groups,
             timed) into f32 [10,000,000, 6]; B-5a (the eight rollup fields)
             over all groups and B-5b (p50/p95/p99) over the 10% timer slice
             and over all groups, each == its twin on the card bit for bit,
             timed single and back to back beside its bytes bound, the launch
             floor (an empty kernel), its twin and (B-5b) torch.nanquantile;
             the same on a flush's shard (62,501 rows) widened to 33, 100 and
             1,000 slots by one timer's batch: 62,500 rows of 6 valid slots
             (a lane a row) and the timer's row (B-5b's long-row launch,
             B-5a's window tree); and on a shard [62,500, 16] whose timers
             each batched 16 values (their rows B-5b's warp route). With
             --parent-b5 (another tree's rollup.cu) that tree's B-5a and
             B-5b are built beside these and timed in turns with them
             (parent, new, new, parent) on each of those inputs, outputs
             equal bit for bit. Then an Aggregator (16 shards,
             1m:40d) end to end through add_timed_batch and flush at a tenth
             of config 4 (1,000,000 series: 90% counters and gauges, 10%
             timers with their 11 default aggregations; the reference's
             ingest is a per-row host loop), plus one untimed timer batching
             33, 100 and 1,000 values in shards 0-2 (wide rows):
             2,000,033 metrics == the same
             buffered state flushed by an Aggregator on the CPU, exactly, one
             B-5a and one B-5b launch a shard, and the ingest, densify,
             device, readback and emit seconds. Last a Downsampler (a
             mapping rule and a per_second rollup by dc over 100 hosts, two
             flushes) == the same on the CPU.
Prints the card as nvidia-smi reports it, a {"kernels": [...]} line, and
as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CHAIN_CYCLES = 4  # latency of a dependent f32 add on Hopper: K3's row-order fold is a chain of them
PARITY_SERIES, MAIN_SERIES, N_POINTS, K, N_UNIQUE = 4096, 1 << 20, 720, 24, 64
QUERY_SERIES, QUERY_JOBS, STEP = 100_000, 10, 10 * 10**9
INDEX_HOSTS, INDEX_SECOND_BLOCK_HOSTS, HOUR = 100_000, 10_000, 3600 * 10**9
# BASELINE config 4: 10M active series, 10 s points rolled up into 1 m windows
AGG_SERIES, AGG_POINTS, AGG_E2E_SERIES = 10_000_000, 6, 1_000_000
AGG_T0 = 1_600_000_020 * 10**9  # a minute boundary
AGG_QS = (0.5, 0.95, 0.99)  # the timers' default quantiles (median, p50, p95, p99)
# a timer batching more than 32 values widens every row of its shard past the
# warp route (pack_dense_groups pads to the widest group): the batch sizes of
# the wide shards, and a shard's rows in the end-to-end flush (16 shards)
AGG_WIDE_P = (33, 100, 1000)
# a shard whose timers (one series in ten) each batched this many values: the
# timers' rows hold 8 < n <= 32 valid slots (B-5b's warp route), the rest 6
AGG_TIMER_BATCH = 16
AGG_SHARD_ROWS = AGG_E2E_SERIES // 16
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
# ten of series). A force-staged query takes seconds end to end, so each
# runs once
DB_SERIES, DB_SHARDS, DB_LIVE_SERIES, DB_LIVE_POINTS = 100_000, 8, 1_000, 360
BLOCK = 2 * 3600 * 10**9  # the Database's default block size
# [ingest]: B-4 at BASELINE config 3's seal (100,000 series x 720 points), and
# two storage nodes, device seal and host seal, over one write_batch
INGEST_LANES, INGEST_E2E_SERIES, INGEST_SEED = 100_000, 1_000, 21
# [stream]: bench_stream.py's batch of series, and the fileset route's series
# (config 3's block)
STREAM_BATCH, STREAM_FILESET_SERIES = 65_536, 100_000
# [hostcodec]: the series on which the Python codec runs beside the library
HOSTCODEC_CHECK = 200
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


def load_parent_scan(path: str):
    """Another tree's ``m3_tpu_torch/parallel/scan.py`` (``--parent-scan``:
    the parent commit's, unpacked beside this checkout in a directory
    .gitignore lists) as a module of this package: its relative imports
    resolve to this checkout's modules, so only its own code differs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("m3_tpu_torch.parallel._parent_scan",
                                                  str(Path(path).resolve()))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scan_turns(parent, packed, s: int, c: int) -> None:
    """[main]'s scan with the parent's reductions and this one's in turns
    (parent, new, new, parent) over the same lanes: the reductions alone
    over one B1 output (CUDA events, median of 20) and the scan end to end
    (B1, the reductions and the count to the host; host clock, median of
    10). The two agree on every count, and on the sums to the order of
    their adds."""
    import torch

    from m3_tpu_torch.ops import fused
    from m3_tpu_torch.parallel import scan

    mods = {"parent": parent, "new": scan}
    kernel = lambda: fused.lane_aggregates(packed.windows, packed.lanes, packed.tile_flags,
                                           n=packed.n, k=K)
    reduce = lambda who, lane: mods[who]._aggregates_from_lanes(
        lane, s, c, lane_order=packed.order, inv=packed.inv)
    lane = kernel()
    a, b = reduce("parent", lane), reduce("new", lane)
    if not torch.equal(a.series_count, b.series_count) or int(a.total_count) != int(b.total_count):
        raise AssertionError("[main] the parent's reductions and this one's count differently")
    rel = ((a.series_sum.double() - b.series_sum.double()).abs()
           / b.series_sum.double().abs().clamp(min=1e-30)).max()
    same = int((a.series_sum.view(torch.int32) == b.series_sum.view(torch.int32)).sum())
    turns = []
    for who in ("parent", "new", "new", "parent"):
        red_ms = statistics.median(cuda_ms(lambda: reduce(who, lane), 20))
        e2e = lambda: int(reduce(who, kernel()).total_count)
        e2e()
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            e2e()
            host.append(time.perf_counter() - t0)
        turns.append(f"{who} {red_ms:.4f} / {statistics.median(host) * 1e3:.3f}")
    log(f"[main] in turns with the parent's parallel/scan.py, reductions ms (CUDA events) / "
        f"scan end to end ms (host clock): {', '.join(turns)}; series sums equal bit for bit "
        f"in {same} of {s}, largest relative difference {float(rel):.3e}; total_sum parent "
        f"{float(a.total_sum)!r}, this {float(b.total_sum)!r}")


def phase_main(dev, worst: float, parent_scan=None):
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
    if parent_scan is not None:
        scan_turns(parent_scan, packed, s, c)

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


def phase_resident(dev, kernels: list, b3_worst: float, main_e2e_s: float, mesh=None) -> dict:
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
    if mesh is not None:  # [mesh]'s NCCL world of one over the same pool
        t0 = time.perf_counter()
        sharded = resident_scan_totals(pool, keys, mesh=mesh, device_out=True)
        torch.cuda.synchronize()
        compare_scans(sharded, out, "resident_scan_totals(mesh=) vs mesh=None")
        log(f"[mesh] resident_scan_totals(mesh=) over the NCCL world of one == mesh=None bit "
            f"for bit at {s} series ({(time.perf_counter() - t0) * 1e3:.1f} ms with the "
            f"all-gather)")
        del sharded

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


def b6_bound(num_bits, w: int, t: int) -> dict:
    """Bytes kernel B-6 must move on these inputs, each once: every series'
    stream words up to its valid bits (at most W), num_bits and
    initial_unit (8 bytes a series), 23 bytes a record (ts, bits,
    values_f32, point_is_float, mult, valid) and the err byte; and its f32
    operations, the value conversion (<= 8) of every record."""
    import torch

    nb = torch.as_tensor(num_bits).to(torch.int64).clamp(min=0)
    s = nb.numel()
    parts = {"words": int(((nb + 31) // 32).clamp(max=w).sum()) * 4, "per_series": s * 9,
             "records": s * t * 23}
    parts["total"] = sum(parts.values())
    bytes_ms = parts["total"] / HBM_BYTES_PER_S * 1e3
    ops_ms = s * t * 8 / F32_FLOP_PER_S * 1e3
    return {"parts": parts, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def compare_decoded(got, want, what: str) -> None:
    """B-6 vs its twin: every field exactly equal, values_f32 by its bits
    with NaN in the same places (the twin on the card leaves the card's own
    NaN bits, the kernel stores 0x7FC00000)."""
    import torch

    for f in ("ts", "bits", "point_is_float", "mult", "valid", "err"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            bad = torch.nonzero(getattr(got, f) != getattr(want, f))[:3].tolist()
            raise AssertionError(f"{what}: {f} differs between kernel B-6 and its twin at {bad}")
    if not same_bits(got.values_f32, want.values_f32):
        raise AssertionError(f"{what}: values_f32 differs between kernel B-6 and its twin")


def load_parent_b6(proc, out):
    """The parent's ``m3_decode_batched`` once its build is done (this
    one's arguments: words, num_bits, initial_unit, s, w, t, int_optimized,
    out_ts, out_bits, out_pif, out_mult, out_valid, out_err, out_f32,
    stream)."""
    import ctypes

    from m3_tpu_torch.ops import _build

    fn = ctypes.CDLL(str(built(proc, out, "B-6"))).m3_decode_batched
    fn.argtypes = _build.SOURCES["lane_aggregates"][2]["m3_decode_batched"]
    fn.restype = ctypes.c_int
    return fn


def b6_turns(parent, args, t: int) -> list:
    """The parent commit's B-6 and this one's in turns (parent, new, new,
    parent) on the same inputs (int_optimized), each through its C entry
    into outputs allocated once (this one's filled with -1 first, so that
    equal outputs show it wrote every byte): a median of 5 single launches
    and a back-to-back run of 5 (CUDA events). All seven outputs must be
    equal bit for bit."""
    import torch

    from m3_tpu_torch.ops._build import load_library

    words, nb, iu = args
    s, w = words.shape
    new = load_library("lane_aggregates").m3_decode_batched

    def outputs(fill):
        return (torch.full((s, t), fill, dtype=torch.int64, device=words.device),
                torch.full((s, t), fill, dtype=torch.int64, device=words.device),
                torch.full((3, s, t), fill % 256, dtype=torch.uint8, device=words.device),
                torch.full((s,), fill % 256, dtype=torch.uint8, device=words.device),
                torch.full((s, t), fill, dtype=torch.int32, device=words.device))

    outs = {"parent": outputs(0), "new": outputs(-1)}

    def call(who):
        ts, bits, small, err, vals = outs[who]
        rc = (parent if who == "parent" else new)(
            words.data_ptr(), nb.data_ptr(), iu.data_ptr(), s, w, t, 1, ts.data_ptr(),
            bits.data_ptr(), small[0].data_ptr(), small[1].data_ptr(), small[2].data_ptr(),
            err.data_ptr(), vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the {who} B-6 launch failed: CUDA error {rc}")

    same = lambda: all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["new"]))
    turns = in_turns(call, same, "B-6", iters=5, b2b=5)
    del outs
    torch.cuda.empty_cache()
    return turns


def phase_batched(dev, kernels: list, main_e2e_s: float, b1_ms: float, parent_b6=None) -> dict:
    """Kernel B-6 == its twin on the parity sets in both modes, then
    scan_aggregate at [main]'s 1M x 720 beside the chunked scan of the same
    series, and B-6 == its twin on that scan's inputs; its launch shape, the
    launch floor and (given ``parent_b6``) the parent's B-6 in turns.
    Returns the single-device scans for [mesh]."""
    import torch

    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.ops import chunked, decode, fused
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.segment.batched import BatchedSegments
    from m3_tpu_torch.utils.synthetic import synthetic_mixed_streams, tiled_batch

    t_phase = time.perf_counter()
    t = N_POINTS
    # 1. parity: one batch of 4,096 series tiling the unique streams of every
    # parity kind and of a synthetic_mixed_streams set (floats, counters,
    # unit changes, annotations), decoded in both modes (the twin on the
    # card is bound by its launches, ~11 s a run whatever the rows)
    uniq = [x for kind, _, _ in KINDS for x in phase_streams(kind)]
    uniq += synthetic_mixed_streams(N_UNIQUE, t, seed=7, frac_tu_change=0.1,
                                    frac_annotation=0.05)
    seg = BatchedSegments.from_streams([uniq[i % len(uniq)] for i in range(PARITY_SERIES)])
    args = decode.batched_device_args(seg, device=dev)
    parity_twin_ms = None
    for io in (True, False):
        got = decode.decode_batched(*args, t, int_optimized=io)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = decode.decode_batched_reference(*args, t, int_optimized=io)
        torch.cuda.synchronize()
        parity_twin_ms = parity_twin_ms or (time.perf_counter() - t0) * 1e3
        compare_decoded(got, want, f"[batched] int_optimized={io}")
        log(f"[batched] B-6 == twin, int_optimized={io!s:5s}: [{PARITY_SERIES}, {t}] tiling "
            f"{len(uniq)} unique streams ({', '.join(k for k, _, _ in KINDS)}, mixed with unit "
            f"changes and annotations) W={seg.num_words} valid={int(want.valid.sum())} "
            f"err_series={int(want.err.sum())} float_points="
            f"{int((want.point_is_float & want.valid).sum())}")
        if io and not bool(want.err.any()):
            raise AssertionError("[batched] no parity series made err")
    del got, want

    # 2. the whole-stream scan at [main]'s scale, counted
    t0 = time.perf_counter()
    seg = tiled_batch(MAIN_SERIES, t, n_unique=N_UNIQUE, seed=3)
    host_s = time.perf_counter() - t0
    args = decode.batched_device_args(seg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode.LAUNCHES = 0
    t0 = time.perf_counter()
    whole = scan.scan_aggregate(*args, t)
    total_count = int(whole.total_count)
    first_s = time.perf_counter() - t0
    launches = decode.LAUNCHES
    if launches < 1:
        raise AssertionError("[batched] scan_aggregate did not launch kernel B-6")
    peak = torch.cuda.max_memory_allocated()

    # per-series == the chunked scan (kernel R) of the same streams
    batch = chunked.build_chunked([seg.stream(i) for i in range(N_UNIQUE)], k=K)
    packed = fused.pack_lanes(batch, order="s", device=dev, n_series=MAIN_SERIES)
    chunked_out = scan.chunked_scan_aggregate(packed, MAIN_SERIES, batch.num_chunks, K)
    for f in ("series_count", "series_min", "series_max", "series_last", "series_sum",
              "series_err"):
        if not same_bits(getattr(whole, f).float(), getattr(chunked_out, f).float()):
            raise AssertionError(f"[batched] scan_aggregate {f} != chunked_scan_aggregate's")
    if total_count != int(chunked_out.total_count) or total_count != MAIN_SERIES * t:
        raise AssertionError(f"[batched] total_count {total_count} vs chunked "
                             f"{int(chunked_out.total_count)}")
    log(f"[batched] scan_aggregate {MAIN_SERIES} series x {t} pts (tiled_batch of "
        f"{N_UNIQUE} gauge streams, seed 3; W={seg.num_words}): per-series count, min, max, "
        f"last, sum and err == chunked_scan_aggregate (kernel R) bit for bit; total_count "
        f"{total_count}, total_sum {float(whole.total_sum)!r} (chunked "
        f"{float(chunked_out.total_sum)!r}); launches {launches}; host tiled_batch "
        f"{host_s:.2f}s, first call {first_s:.3f}s")
    del packed

    run = lambda: decode.decode_batched(*args, t)
    run()
    b6_ms = statistics.median(cuda_ms(run, 5))
    b6_b2b = per_launch_ms(run, 5)

    def e2e():
        return int(scan.scan_aggregate(*args, t).total_count)

    e2e()
    e2e_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        e2e()
        e2e_s.append(time.perf_counter() - t0)
    e2e_med = statistics.median(e2e_s)

    # B-6 against its twin at the main path's shape, every field
    got = decode.decode_batched(*args, t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = decode.decode_batched_reference(*args, t)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    compare_decoded(got, want, f"[batched] [{MAIN_SERIES}, {t}]")
    diff = (got.values_f32 - want.values_f32).abs()
    max_err = float(torch.where(diff.isnan(), 0.0, diff).max())
    log(f"[batched] B-6 == twin at [{MAIN_SERIES}, {t}] (the scan's inputs): ts, bits, "
        f"point_is_float, mult, valid, err and values_f32 bit for bit; valid "
        f"{int(want.valid.sum())}; twin {twin_ms:.1f} ms")
    del got, want, diff
    torch.cuda.empty_cache()
    floor_ms = statistics.median(cuda_ms(lambda: IK.launch_floor(dev), 20))
    shape = decode.launch_shape(MAIN_SERIES)
    turns = b6_turns(parent_b6, args, t) if parent_b6 is not None else None
    bd = b6_bound(args[1], seg.num_words, t)
    log("[batched] B-6 bytes needed: " + ", ".join(
        f"{k_} {v / 1e9:.4f} GB" for k_, v in bd["parts"].items()))
    log(f"[batched] B-6 (decode_batched) [{MAIN_SERIES}, {t}] W={seg.num_words} warm median "
        f"{b6_ms:.3f} ms [{b6_b2b:.3f} back to back] (5 launches, CUDA events); launch floor "
        f"{floor_ms:.4f} ms; bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']}; {bd['bound_ms'] / b6_ms:.1%} of roofline; f32 ops "
        f"{bd['ops_ms']:.4f} ms); twin {twin_ms:.1f} ms on the same inputs "
        f"({parity_twin_ms:.1f} ms on the [{PARITY_SERIES}, {t}] parity set); "
        f"scan_aggregate end to end {e2e_med * 1e3:.3f} ms, median of 3 = "
        f"{total_count / e2e_med:.4e} datapoints/s; [main] chunked B1 scan end to end "
        f"{main_e2e_s * 1e3:.3f} ms (B1 {b1_ms:.3f} ms): whole-stream / chunked = "
        f"{main_e2e_s / e2e_med:.3f}x the chunked rate")
    log(f"[batched] B-6 launch: {shape['warps']} warps a block (a series a lane), "
        f"{shape['blocks']:,} blocks ({shape['resident_blocks']:,} resident at once), "
        f"{shape['smem_bytes']:,} B of shared memory a block, {shape['registers']} registers and "
        f"{shape['local_bytes']} B of local memory a thread; flushes every {shape['group']} "
        f"records (u8 planes every {shape['flag_group']}), rings of {shape['ring_words']} words; "
        f"ptxas: {ptxas_report('lane_aggregates', 'decode_batched_kernel')}")
    if turns is not None:
        log(f"[batched] B-6 in turns with the parent's (C entries, outputs equal bit for bit, ms "
            f"single [back to back]): {fmt_turns(turns)}; bound {bd['bound_ms']:.3f} ms, launch "
            f"floor {floor_ms:.4f} ms")
    log(f"[batched] peak device memory of scan_aggregate {peak / 1e9:.2f} GB")
    log("[batched] library_ms for B-6: no single PyTorch call computes an M3TSZ decode; null")
    log(f"[batched] phase {time.perf_counter() - t_phase:.1f}s")
    kernels.append({
        "name": "decode_batched",
        "route": "cuda",
        "source": "m3_tpu_torch/ops/csrc/lane_aggregates.cu",
        "replaces": "m3_tpu/ops/decode.py:542",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": b6_ms,
        "plain_ms": twin_ms,
        "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"],
        "library_ms": None,
        "b2b_ms": b6_b2b,
        "launch_floor_ms": floor_ms,
        "launch_shape": shape,
        **({"parent_turns": turns} if turns is not None else {}),
    })
    return {"args": args, "whole": whole, "chunked": chunked_out, "batch": batch}


def open_mesh():
    """A world of one over NCCL, rendezvous through a FileStore under the
    checkout's build/ (no TCP, no environment), and its series mesh."""
    import tempfile

    import torch.distributed as dist

    from m3_tpu_torch.parallel.mesh import series_mesh

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh-", dir=root)) / "store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    mesh = series_mesh()
    log(f"[mesh] NCCL world of one: rank {mesh.rank} of {mesh.size} on {mesh.device}")
    return mesh, store.parent


def close_mesh(store_dir) -> None:
    import shutil

    import torch.distributed as dist

    dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)


def phase_mesh(dev, mesh, single: dict) -> None:
    """The sharded scans over the NCCL world of one at [main]'s scale ==
    the single-device scans bit for bit; the all-reduce's time."""
    import torch

    from m3_tpu_torch.ops import chunked, decode, fused
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.parallel.mesh import series_sharding

    t_phase = time.perf_counter()
    shard = series_sharding(mesh)
    args, batch = single["args"], single["batch"]
    local = [shard(x) for x in args]
    decode.LAUNCHES = chunked.LAUNCHES = 0
    got = scan.make_sharded_scan(mesh, N_POINTS)(*local)
    compare_scans(got, single["whole"], "make_sharded_scan vs scan_aggregate")
    packed = fused.pack_lanes(batch, order="s", device=dev, n_series=MAIN_SERIES)
    got_c = scan.make_sharded_chunked_scan(mesh, MAIN_SERIES, batch.num_chunks, K)(packed)
    compare_scans(got_c, single["chunked"], "make_sharded_chunked_scan vs chunked_scan_aggregate")
    torch.cuda.synchronize()
    if decode.LAUNCHES < 1 or chunked.LAUNCHES < 1:
        raise AssertionError(f"[mesh] launches B-6 {decode.LAUNCHES}, R {chunked.LAUNCHES}")
    del packed, got_c
    log(f"[mesh] make_sharded_scan == scan_aggregate and make_sharded_chunked_scan == "
        f"chunked_scan_aggregate bit for bit at {MAIN_SERIES} x {N_POINTS} (launches B-6 "
        f"{decode.LAUNCHES}, R {chunked.LAUNCHES})")
    x = torch.ones((), dtype=torch.float32, device=mesh.device)
    one_ms = statistics.median(cuda_ms(lambda: mesh.all_reduce(x, "sum"), 20))
    four_ms = statistics.median(cuda_ms(lambda: scan._mesh_totals(
        mesh, got.total_sum, got.total_count, got.total_min, got.total_max), 20))
    log(f"[mesh] NCCL all-reduce of one f32 {one_ms:.4f} ms (median of 20, CUDA events); the "
        f"scan's four totals (sum, count, min, max and the NaN rule) {four_ms:.4f} ms")
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f}s")


def phase_stream(dev) -> None:
    """stream_aggregate over [main]'s series in 16 batches of 65,536, each of
    other streams, with two in flight, == the sum of each batch's own
    packed scan; then the fileset route
    over one fileset of 100,000 series written with the native encoder."""
    import shutil
    import tempfile

    import torch

    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.ops.sideplane import pack_side_rows
    from m3_tpu_torch.parallel import stream
    from m3_tpu_torch.parallel.scan import chunked_scan_aggregate_packed
    from m3_tpu_torch.storage import fs
    from m3_tpu_torch.utils.synthetic import synthetic_streams

    t_phase = time.perf_counter()
    n_batches = MAIN_SERIES // STREAM_BATCH
    # every batch holds other streams (64 unique ones of seed 3 + b, tiled):
    # a kernel that read a buffer before its upload finished, or another
    # batch's, would change the totals
    t0 = time.perf_counter()
    hosts = [next(stream.packed_batches([chunked.tile_chunked(chunked.build_chunked(
        synthetic_streams(N_UNIQUE, N_POINTS, seed=3 + b), k=K), STREAM_BATCH)]))
        for b in range(n_batches)]
    pack_s = (time.perf_counter() - t0) / n_batches
    batch_bytes = sum(x.numel() * x.element_size() for x in hosts[0][0][:3])

    # the oracle: each batch's own packed scan on the card
    on_card = lambda h: h[0]._replace(windows=h[0].windows.to(dev), lanes=h[0].lanes.to(dev),
                                      tile_flags=h[0].tile_flags.to(dev))
    refs = []
    for h in hosts:
        o = chunked_scan_aggregate_packed(on_card(h), *h[1:])
        refs.append((float(o.total_sum), int(o.total_count), float(o.total_min),
                     float(o.total_max)))
    if len({r[0] for r in refs}) != n_batches:
        raise AssertionError("[stream] the batches' packed scans do not all differ")
    want_sum = sum(r[0] for r in refs)
    want_count = sum(r[1] for r in refs)
    want_min, want_max = min(r[2] for r in refs), max(r[3] for r in refs)
    dev_lanes = on_card(hosts[0])
    b1_ms = statistics.median(cuda_ms(lambda: fused.lane_aggregates(
        dev_lanes.windows, dev_lanes.lanes, dev_lanes.tile_flags, n=dev_lanes.n, k=K), 10))
    del dev_lanes

    fused.LAUNCHES = 0
    drains = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    totals = stream.stream_aggregate(hosts, prefetch=2, drain_times=drains, device=dev)
    got = totals.finalize()
    wall = time.perf_counter() - t0
    if fused.LAUNCHES != n_batches:
        raise AssertionError(f"[stream] {fused.LAUNCHES} B1 launches for {n_batches} batches")
    if got[1] != want_count or not abs(got[0] - want_sum) <= 1e-6 * abs(want_sum) \
            or (got[2], got[3]) != (want_min, want_max):
        raise AssertionError(f"[stream] totals {got} vs the per-batch packed scans' "
                             f"({want_sum!r}, {want_count}, {want_min!r}, {want_max!r})")
    del hosts
    steady = statistics.median(np.diff(drains)) if len(drains) > 2 else float("nan")
    log(f"[stream] {n_batches} batches of {STREAM_BATCH} series x {N_POINTS} pts, each of other "
        f"streams (64 unique gauge streams of seeds 3..{2 + n_batches}, tiled; k={K}, "
        f"prefetch=2, pinned uploads on a side stream): count {got[1]} == the sum of each "
        f"batch's own packed scan, sum {got[0]!r} (theirs {want_sum!r}), min {got[2]!r} and "
        f"max {got[3]!r} == theirs")
    log(f"[stream] wall {wall:.3f} s = {got[1] / wall:.4e} points/s; steady-state interval "
        f"{steady * 1e3:.3f} ms a batch (median of the drain stamps' differences); upload "
        f"{batch_bytes / 1e6:.1f} MB a batch = {batch_bytes / steady / 1e9:.2f} GB/s at the "
        f"interval ({batch_bytes * n_batches / wall / 1e9:.2f} GB/s over the wall); B1 "
        f"{b1_ms:.3f} ms a batch (CUDA events, median of 10); host packing "
        f"{pack_s:.2f} s a batch (outside the wall)")

    # the fileset route: one fileset of config 3's block, series i holding
    # unique stream i % 64 (native encoder), side rows computed once a
    # unique stream (as [database] writes its block)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    base_dir = tempfile.mkdtemp(prefix="chip_smoke_stream-", dir=root)
    try:
        b0 = T0 // BLOCK * BLOCK
        uniq = synthetic_streams(N_UNIQUE, N_POINTS, seed=5, start_nanos=b0)
        rows = [pack_side_rows(chunked.snapshot_stream(x, K), b0) for x in uniq]
        if any(r is None for r in rows):
            raise AssertionError("[stream] a unique stream's side rows overflow the packed layout")
        ids = [b"stream-%06d" % i for i in range(STREAM_FILESET_SERIES)]
        t0 = time.perf_counter()
        fid = fs.FilesetID("m3", 0, b0, 0)
        fs.write_fileset(base_dir, fid, {sid: uniq[i % N_UNIQUE] for i, sid in enumerate(ids)},
                         BLOCK, K, side_rows={sid: rows[i % N_UNIQUE] for i, sid in enumerate(ids)})
        write_s = time.perf_counter() - t0
        reader = fs.FilesetReader(base_dir, fid)
        fused.LAUNCHES = 0
        t0 = time.perf_counter()
        ftotals = stream.stream_aggregate(
            stream.fileset_packed_batches([reader], batch_series=STREAM_BATCH), device=dev)
        fgot = ftotals.finalize()
        fwall = time.perf_counter() - t0
        f_launches = fused.LAUNCHES
        if f_launches != ftotals.batches:
            raise AssertionError(f"[stream] {f_launches} B1 launches for {ftotals.batches} "
                                 f"fileset batches")
        # the same batches from the streams, prescanned: the unique streams'
        # lanes gathered in the reader's series order
        base_u = chunked.build_chunked(uniq, k=K)
        order = np.asarray([int(sid[len(b"stream-"):]) % N_UNIQUE for sid in reader.series_ids])
        fsum, fcount = 0.0, 0
        for i in range(0, len(order), STREAM_BATCH):
            b = chunked.select_series(base_u, order[i:i + STREAM_BATCH])
            out = chunked_scan_aggregate_packed(fused.pack_lanes(b, device=dev),
                                                s=b.num_series, c=b.num_chunks, k=K)
            fsum += float(out.total_sum)
            fcount += int(out.total_count)
        if fgot[1] != fcount or fcount != STREAM_FILESET_SERIES * N_POINTS \
                or not abs(fgot[0] - fsum) <= 1e-6 * abs(fsum):
            raise AssertionError(f"[stream] fileset totals {fgot[:2]} vs the streams' "
                                 f"({fsum!r}, {fcount})")
        log(f"[stream] fileset route: {STREAM_FILESET_SERIES} series x {N_POINTS} pts (64 "
            f"unique gauge streams of seed 5 from the native encoder; write_fileset with "
            f"their side rows {write_s:.2f} s) in {ftotals.batches} batches straight off the "
            f"side tables ({f_launches} B1 launches): count {fgot[1]} == the same batches "
            f"prescanned from the streams, sum {fgot[0]!r} (theirs {fsum!r}); {fwall:.3f} s "
            f"with the reads and packing")
    finally:
        shutil.rmtree(base_dir, ignore_errors=True)
    log(f"[stream] phase {time.perf_counter() - t_phase:.1f}s")


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


def b1_check(rec, lo: int, hi: int, grid, lookback: int, tag: str) -> dict:
    """Kernel B-1 (the step-grid consolidation) against its plain torch twin
    on the card, values and counts bit for bit, then its time (median of 10
    single launches and back to back, CUDA events), its bytes bound (each
    record's 19 bytes read once, the grid once, values and counts written
    once) and the twin's time on the card."""
    import torch

    from m3_tpu_torch.query import plan as qplan

    launches = qplan.LAUNCHES
    got, got_counts = qplan.consolidate_grid(rec, lo, hi, grid, lookback)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_counts = qplan.consolidate_grid_reference(rec, lo, hi, grid, lookback)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(got.view(torch.int64), want.view(torch.int64))
            and torch.equal(got_counts, want_counts)):
        raise AssertionError(f"[{tag}] B-1 differs from its twin")
    run = lambda: qplan.consolidate_grid(rec, lo, hi, grid, lookback)
    ms = statistics.median(cuda_ms(run, 10))
    b2b = per_launch_ms(run)
    qplan.LAUNCHES = launches  # checks and timing are not the main path's launches
    s, p = rec.ts.shape
    t = got.shape[1]
    nbytes = s * p * 19 + t * 8 + s * t * 8 + s * 4
    return {"shape": f"[{s}, {p}] -> [{s}, {t}]", "ms": ms, "b2b": b2b, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "datapoints": int(got_counts.sum())}


def ptxas_report(lib: str, kernel: str) -> str:
    """Each instantiation of ``kernel`` as ``nvcc -Xptxas -v`` reported it
    in this run's build of ``lib``: registers, shared memory, spills."""
    from m3_tpu_torch.ops import _build

    text = _build.BUILD_LOG.get(lib)
    if not text:
        return "not in this run's build log"
    entries, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = None
            if kernel in name:  # a template instantiation's mangled name: <true> is ILb1E,
                # an int argument n is ILin
                args = [a for a in name.split("I", 1)[-1].split("E") if a.startswith("Li")]
                flag = ("true" if "ILb1E" in name or "Lb1E" in name else
                        "false" if "ILb0E" in name or "Lb0E" in name else "")
                parts = [a[2:] for a in args] + ([flag] if flag else [])
                cur = kernel + (f"<{','.join(parts)}>" if parts else "")
                entries[cur] = []
        elif cur is not None and ("Used" in line or "spill" in line):
            entries[cur].append(line.split(":", 1)[-1].strip())
    return "; ".join(f"{name}: {', '.join(info)}" for name, info in entries.items()) or "none"


def build_parent(source: str, lib: str):
    """Starts nvcc on another tree's source of library ``lib``
    (``--parent-b1`` / ``--parent-b4`` / ``--parent-b5`` / ``--parent-b6`` / ``--parent-b7``: the parent
    commit's source,
    unpacked beside this checkout in a directory .gitignore lists), with
    this checkout's flags, into build/kernels. Returns (process, library
    path)."""
    import hashlib
    from pathlib import Path

    from m3_tpu_torch.ops import _build

    src = Path(source).resolve()
    flags = _build.SOURCES[lib][1]
    header = next(d / "csrc" / "launch.cuh" for d in src.parents
                  if (d / "csrc" / "launch.cuh").exists())
    digest = hashlib.sha256(src.read_bytes() + header.read_bytes()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"parent_{lib}_{digest}.so"
    proc = subprocess.Popen([_build.nvcc_path(), *flags, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def load_parent_b1(proc, out):
    """The parent's ``m3_consolidate_grid`` once its build is done: its
    entry takes the arguments of the entry before ``tile`` and ``run``
    (ts, bits, point_is_float, mult, valid, s, p, lo, hi, grid, t,
    lookback, values, counts, stream)."""
    import ctypes

    fn = ctypes.CDLL(str(built(proc, out, "B-1"))).m3_consolidate_grid
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [P, P, P, P, P, I64, I64, I64, I64, P, I64, I64, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def built(proc, out, what: str):
    """The library ``out`` once its nvcc process is done (raises if it
    failed)."""
    log_text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the parent's {what} did not build:\n{log_text}")
    return out


def load_parent_b7(proc, out):
    """The parent's ``m3_temporal_window`` and its scratch query once its
    build is done: its entry takes the arguments of this one's but
    ``first`` (it computes every column): x, rows, cols, window, fn, a, b,
    c, d, run, force_global, out, scratch, scratch_bytes, stream."""
    import ctypes

    lib = ctypes.CDLL(str(built(proc, out, "B-7")))
    P, I, I64, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.m3_temporal_window.argtypes = [P, I64, I, I, I, F, F, F, F, I, I, P, P, I64, P]
    lib.m3_temporal_window.restype = I
    lib.m3_temporal_window_scratch_bytes.argtypes = [I64, I, I, I, I, I]
    lib.m3_temporal_window_scratch_bytes.restype = I64
    return lib


def load_parent_b5(proc, out):
    """The parent's ``m3_aggregate_dense`` (this one's arguments) and
    ``m3_dense_quantiles`` (no scratch: vals, valid, g, p, qs, nq, out,
    stream) once its build is done."""
    import ctypes

    lib = ctypes.CDLL(str(built(proc, out, "B-5")))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.m3_aggregate_dense.argtypes = [P, P, P, I64, I64, P, P]
    lib.m3_aggregate_dense.restype = I
    lib.m3_dense_quantiles.argtypes = [P, P, I64, I64, P, I, P, P]
    lib.m3_dense_quantiles.restype = I
    return lib


def load_parent_b4(proc, out):
    """The parent's ``m3_encode_lanes`` once its build is done (this one's
    arguments: t0, counts, float_lane, dod, vbits, m, t, k, w, c, words,
    total_bits, chunk_offs, chunk_sigs, stream)."""
    import ctypes

    from m3_tpu_torch.ops import _build

    fn = ctypes.CDLL(str(built(proc, out, "B-4"))).m3_encode_lanes
    fn.argtypes = _build.SOURCES["encode"][2]["m3_encode_lanes"]
    fn.restype = ctypes.c_int
    return fn


def b4_outputs(inp, fill: int = 0):
    """B-4's four outputs for ``inp``'s planes, on its device, filled with
    ``fill``."""
    import torch

    T, M = inp.dod.shape
    C = (T + inp.k - 1) // inp.k
    return tuple(torch.full(shape, fill, dtype=torch.int32, device=inp.dod.device)
                 for shape in ((M, inp.words), (M,), (C, M), (C, M)))


def b4_call(fn, inp, outs) -> None:
    """One B-4 launch through a C entry ``fn`` (this tree's or the
    parent's) into ``outs``."""
    import torch

    T, M = inp.dod.shape
    rc = fn(inp.t0.data_ptr(), inp.counts.data_ptr(), inp.float_lane.data_ptr(),
            inp.dod.data_ptr(), inp.vbits.data_ptr(), M, T, inp.k, inp.words, outs[2].shape[0],
            *(o.data_ptr() for o in outs), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"a B-4 launch failed: CUDA error {rc}")


def b4_turns(parent, inp) -> list:
    """The parent commit's B-4 and this one's in turns (parent, new, new,
    parent) on the same planes, each through its C entry into outputs
    allocated once (this one's filled with -1 first, so that equal outputs
    show it wrote every word): a median of 10 single launches and a
    back-to-back run of 20 (CUDA events). All four outputs must be equal
    bit for bit."""
    import torch

    from m3_tpu_torch.ops._build import load_library

    new = load_library("encode").m3_encode_lanes
    outs = {"parent": b4_outputs(inp), "new": b4_outputs(inp, -1)}
    call = lambda who: b4_call(parent if who == "parent" else new, inp, outs[who])
    same = lambda: all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["new"]))
    return in_turns(call, same, "B-4")


def b5_turns(parent, v, t, ok, qs=None) -> list:
    """The parent commit's B-5a (qs None) or B-5b and this one's in turns
    (parent, new, new, parent) on the same inputs, each through its C entry
    into outputs (and B-5b's work list) allocated once: a median of 10
    single launches and a back-to-back run of 20 (CUDA events). The
    parent's outputs must equal this one's bit for bit."""
    import ctypes

    import torch

    from m3_tpu_torch.ops._build import load_library

    g, p = v.shape
    new = load_library("rollup")
    stream = torch.cuda.current_stream().cuda_stream
    rows = 8 if qs is None else len(qs)
    outs = {who: torch.empty((rows, g), dtype=torch.float32, device=v.device)
            for who in ("parent", "new")}
    scratch = torch.empty(g + 1, dtype=torch.int64, device=v.device)
    q = None if qs is None else (ctypes.c_float * len(qs))(*qs)

    def call(who):
        lib, out = (parent if who == "parent" else new), outs[who].data_ptr()
        if qs is None:
            rc = lib.m3_aggregate_dense(v.data_ptr(), t.data_ptr(), ok.data_ptr(), g, p, out, stream)
        elif who == "parent":
            rc = lib.m3_dense_quantiles(v.data_ptr(), ok.data_ptr(), g, p, q, len(qs), out, stream)
        else:
            rc = lib.m3_dense_quantiles(v.data_ptr(), ok.data_ptr(), g, p, q, len(qs),
                                        scratch.data_ptr(), out, stream)
        if rc != 0:
            raise RuntimeError(f"the {who} B-5 launch failed: CUDA error {rc}")

    return in_turns(call, lambda: same_bits(outs["parent"], outs["new"]),
                     f"B-5{'a' if qs is None else 'b'} on [{g}, {p}]")


def in_turns(call, same, what: str, iters: int = 10, b2b: int = 20,
             profile: bool = False) -> list:
    """The parent commit's kernel and this one's in turns (parent, new,
    new, parent): ``call(who)`` launches one side into outputs of its own,
    and after one launch each ``same()`` must hold (the outputs equal bit
    for bit). A turn: (who, a median of `iters` single launches, a
    back-to-back run of `b2b` (CUDA events), and with `profile` the device
    time a launch (torch.profiler))."""
    import torch

    call("parent")
    call("new")
    torch.cuda.synchronize()
    if not same():
        raise AssertionError(f"the parent's {what} and this one's differ")
    turns = []
    for who in ("parent", "new", "new", "parent"):
        f = lambda who=who: call(who)
        turn = (who, statistics.median(cuda_ms(f, iters)), per_launch_ms(f, b2b))
        turns.append(turn + ((sum(device_us(f).values()) / 1e3,) if profile else ()))
    return turns


def fmt_turns(turns: list) -> str:
    return ", ".join(f"{who} {ms:.4f} [{b2b:.4f}]" for who, ms, b2b in turns)


def b1_turns(parent, rec, lo: int, hi: int, grid, lookback: int) -> list:
    """The parent commit's B-1 and this one's in turns (parent, new, new,
    parent) on the same inputs, each through its C entry into outputs
    allocated once: a median of 10 single launches, a back-to-back run of
    20 (CUDA events) and the device time a launch (torch.profiler). The
    parent's values and counts must equal this one's bit for bit."""
    import torch

    from m3_tpu_torch.ops._build import load_library

    s, p = rec.ts.shape
    g = torch.as_tensor(np.asarray(grid, np.int64)).cuda()
    t = g.numel()
    ins = [x.contiguous() for x in (rec.ts, rec.bits, rec.point_is_float, rec.mult, rec.valid)]
    outs = {name: (torch.empty((s, t), dtype=torch.float64, device="cuda"),
                   torch.empty(s, dtype=torch.int32, device="cuda")) for name in ("parent", "new")}
    new = load_library("consolidate_grid").m3_consolidate_grid
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        v, c = outs[name]
        head = (*[x.data_ptr() for x in ins], s, p, int(lo), int(hi), g.data_ptr(), t,
                int(lookback), v.data_ptr(), c.data_ptr())
        rc = parent(*head, stream) if name == "parent" else new(*head, 0, 0, stream)
        if rc != 0:
            raise RuntimeError(f"the {name} B-1 launch failed: CUDA error {rc}")

    same = lambda: (torch.equal(outs["parent"][0].view(torch.int64),
                                outs["new"][0].view(torch.int64))
                    and torch.equal(outs["parent"][1], outs["new"][1]))
    return in_turns(call, same, "B-1", profile=True)


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


def phase_query(dev, kernels: list, temporal_err: float, parent_b1=None) -> dict:
    import torch

    from m3_tpu_torch.block.core import Bounds, make_tags
    from m3_tpu_torch.codec.m3tsz import decode
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.ops import chunked
    from m3_tpu_torch.query import engine as E
    from m3_tpu_torch.query.functions import aggregation as A
    from m3_tpu_torch.query.functions import temporal_fused as TF
    from m3_tpu_torch.ops.decode import DecodeResult
    from m3_tpu_torch.query import plan as qplan
    from m3_tpu_torch.query.m3_storage import BlockStorage
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
    qplan.LAUNCHES = 0
    for k in IK.LAUNCHES:
        IK.LAUNCHES[k] = 0
    results = {fn: eng.query_range(q, start, end, STEP) for fn, q in queries.items()}
    fanout = eng.query_range(FANOUT_QUERY, start, end, STEP)
    torch.cuda.synchronize()
    launches = {"decode_records": chunked.LAUNCHES, "consolidate_grid": qplan.LAUNCHES,
                "temporal_fused": TF.LAUNCHES, "grouped_reduce": A.LAUNCHES,
                "index_match_terms": IK.LAUNCHES["match_terms"],
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
    # B-1 at the query's (and [database]'s) shape, and at a small ragged one
    b1 = b1_check(rec_s, lo, hi, grid, lookback, "query")
    ragged = DecodeResult(*[None if x is None else
                            x[:333, :517].contiguous() if x.dim() == 2 else x[:333]
                            for x in rec_s])
    b1_ragged = b1_check(ragged, lo, hi, grid[:301], lookback, "query")
    del ragged
    b1_shape = qplan.consolidate_grid_shape(s_q, rec_s.ts.shape[1], len(grid))
    b1_pairs = (b1_turns(parent_b1, rec_s, lo, hi, grid, lookback) if parent_b1 is not None
                else None)
    # the launch floor: an empty kernel through the same ctypes route
    floor_ms = statistics.median(cuda_ms(lambda: IK.launch_floor(dev), 20))
    floor_b2b = per_launch_ms(lambda: IK.launch_floor(dev))
    b1["floor_ms"] = floor_ms
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
    for what, b in (("the query's", b1), ("ragged", b1_ragged)):
        log(f"[query] B-1 (consolidate_grid) {what} {b['shape']}: {b['ms']:.3f} ms (median of 10, "
            f"CUDA events; back-to-back {b['b2b']:.3f} ms); bound {b['bound_ms']:.3f} ms "
            f"({b['bytes'] / 1e9:.4f} GB at 3.35 TB/s = {b['bound_ms'] / b['ms']:.1%} of "
            f"roofline); twin {b['plain_ms']:.1f} ms; == twin bit for bit (values and "
            f"{b['datapoints']} datapoints)")
    log(f"[query] B-1 launch floor (empty kernel, same route): {floor_ms:.4f} ms (median of 20, "
        f"back-to-back {floor_b2b:.4f} ms); B-1 {b1['ms']:.3f} ms is {b1['ms'] / floor_ms:.1f}x it, "
        f"ragged {b1_ragged['ms']:.3f} ms {b1_ragged['ms'] / floor_ms:.1f}x")
    log(f"[query] B-1 launch at the query's shape: {b1_shape['blocks']} blocks of "
        f"{b1_shape['warps']} warps (resident_blocks {b1_shape['resident_blocks']}), "
        f"{b1_shape['smem_bytes']} bytes of shared memory a block, {b1_shape['registers']} "
        f"registers a thread, tile {b1_shape['tile']} records, run {b1_shape['run']} steps a lane, "
        f"grid in shared memory {bool(b1_shape['grid_in_smem'])}; ptxas: "
        f"{ptxas_report('consolidate_grid', 'consolidate_grid_kernel')}")
    if b1_pairs is not None:
        log(f"[query] B-1 in turns with the parent's at {b1['shape']} (C entries, outputs "
            f"allocated once; == bit for bit): " + "; ".join(
                f"{name} {ms:.3f} ms (back-to-back {b2b:.3f} ms, device {dev_ms:.3f} ms)"
                for name, ms, b2b, dev_ms in b1_pairs))
    log("[query] library_ms for B-1: no PyTorch call does a lookback upper bound with a value "
        "pick; null")
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
    return b1, storage


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
    k2t_twin = IK.bitmap_from_terms_reference(a0.host_post_idx, a0.post_data, gis, a0.n_words)
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


def profiled(fn, top: int = 0) -> dict:
    """One fn() under torch.profiler: the device-to-host copies the card
    ran, the device time of its kernels and copies (the device-side events
    only) and the host-clock time, ending in a synchronize; with ``top``,
    the ``top`` device events that took the most time (name, ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_key = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return {"dtoh": sum(1 for e in dev if "DtoH" in e.name),
            "device_ms": sum(ms for _, ms in by_key),
            "wall_ms": wall * 1e3,
            "top": sorted(by_key, key=lambda x: -x[1])[:top]}


def phase_database(dev, kernels: list, b2_resident: dict, b1_query: dict) -> None:
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from m3_tpu_torch.block.core import Bounds, SeriesMeta, make_tags
    from m3_tpu_torch.index.device import IndexDeviceOptions
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.ops.sideplane import pack_side_rows
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.query import engine as E
    from m3_tpu_torch.query import plan as qplan
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
        # streamed series pays its host prescan (PERF.md), so a streamed
        # scan of the whole block would take many seconds
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

        # 3. queries through Engine over M3Storage, served by the query plan,
        # each held bit for bit to the same query force-staged, to the same
        # query over BlockStorage on the same streams in the same series
        # order, and to a second run
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
        # the main path, counted: both queries (the first builds its plan)
        # and a resident scan, the counts set to 0 just before and read just
        # after
        chunked.LAUNCHES = fused.LAUNCHES = TF.LAUNCHES = A.LAUNCHES = scan.ASSEMBLY_LAUNCHES = 0
        qplan.LAUNCHES = 0
        for k in IK.LAUNCHES:
            IK.LAUNCHES[k] = 0
        errors = qplan._M_ERRORS.value
        results, cold, routing = {}, {}, {}
        for fn, q in queries.items():
            rec = stats.start(q)
            rec.record_routing = True
            t0 = time.perf_counter()
            results[fn] = eng.query_range(q, start, end, STEP)
            results[fn].values.cpu()
            cold[fn] = time.perf_counter() - t0
            stats.finish(rec, cold[fn])
            routing[fn] = rec
        resident = st.scan_totals(m_all, b0, b0 + BLOCK)
        torch.cuda.synchronize()
        launches = {"resident_assembly": scan.ASSEMBLY_LAUNCHES, "decode_records": chunked.LAUNCHES,
                    "consolidate_grid": qplan.LAUNCHES, "lane_aggregates": fused.LAUNCHES,
                    "temporal_fused": TF.LAUNCHES, "grouped_reduce": A.LAUNCHES,
                    "index_match_terms": IK.LAUNCHES["match_terms"],
                    "index_bitmap": IK.LAUNCHES["bitmap_from_spans"]}
        log(f"[database] launches on the main path (2 queries, 1 scan): {launches}")
        for name, n in launches.items():
            if n < 1:
                raise AssertionError(f"the [database] path did not launch {name}")
        for fn, rec in routing.items():
            staged_reasons = sorted({r["reason"] for r in rec.routing if r["path"] == "staged"})
            log(f"[database] {queries[fn]}: plan hits {rec.plan_hits}, misses {rec.plan_misses}, "
                f"fallbacks {rec.plan_fallbacks}, device dispatches {rec.device_dispatches}; "
                f"staged routes {staged_reasons or 'none'}")
            if (rec.plan_hits + rec.plan_misses < 1 or rec.plan_fallbacks
                    or qplan._M_ERRORS.value != errors):
                raise AssertionError(f"[database] {queries[fn]} was not served by the plan: "
                                     f"{rec.to_dict()}, plan errors "
                                     f"{qplan._M_ERRORS.value - errors}")
        staged = {}
        for fn, q in queries.items():
            got = results[fn]
            t0 = time.perf_counter()
            with qplan.force_staged():
                forced = eng.query_range(q, start, end, STEP)
            forced.values.cpu()
            staged[fn] = time.perf_counter() - t0
            for what, want in (("force_staged()", forced),
                               ("BlockStorage", beng.query_range(q, start, end, STEP)),
                               ("a second run", eng.query_range(q, start, end, STEP))):
                if ([m.tags for m in got.metas] != [m.tags for m in want.metas]
                        or not same_bits(got.values, want.values)):
                    raise AssertionError(f"[database] {q} over the plan differs from {what}")
        log(f"[database] both queries over M3Storage (plan-served) == the same queries "
            f"force-staged, == over BlockStorage, and == a second run, bit for bit, values and "
            f"metas ([{len(results['rate'].metas)}, {results['rate'].values.shape[1]}])")
        e2e = {}
        for fn, q in queries.items():
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                eng.query_range(q, start, end, STEP).values.cpu()
                times.append(time.perf_counter() - t0)
            e2e[fn] = statistics.median(times)
        # a warm query's launches by kernel, and its device-to-host copies
        chunked.LAUNCHES = fused.LAUNCHES = TF.LAUNCHES = A.LAUNCHES = scan.ASSEMBLY_LAUNCHES = 0
        qplan.LAUNCHES = 0
        for k in IK.LAUNCHES:
            IK.LAUNCHES[k] = 0
        eng.query_range(queries["rate"], start, end, STEP)
        torch.cuda.synchronize()
        warm = {"index_match_terms": IK.LAUNCHES["match_terms"],
                "index_bitmap": IK.LAUNCHES["bitmap_from_spans"],
                "resident_assembly": scan.ASSEMBLY_LAUNCHES, "decode_records": chunked.LAUNCHES,
                "consolidate_grid": qplan.LAUNCHES, "temporal_fused": TF.LAUNCHES,
                "grouped_reduce": A.LAUNCHES}
        prof = profiled(lambda: eng.query_range(queries["rate"], start, end, STEP))
        log(f"[database] a warm plan-served query ({queries['rate']}) launches {warm} and makes "
            f"{prof['dtoh']} device-to-host cop{'y' if prof['dtoh'] == 1 else 'ies'}; device time "
            f"{prof['device_ms']:.3f} ms of {prof['wall_ms']:.1f} ms (torch.profiler)")
        if prof["dtoh"] != 1:
            raise AssertionError(f"[database] a warm query made {prof['dtoh']} device-to-host "
                                 f"copies")
        # the warm plan execution alone (M3Storage.fetch_grid: index match,
        # gather, B-2, R, B-1, the readback), and the engine's host grouping
        grid = Bounds(start - 6 * STEP, STEP, N_POINTS + 6).timestamps()
        fetch_s = []
        for _ in range(10):
            t0 = time.perf_counter()
            metas, _, _ = st.fetch_grid(m_all, start - 6 * STEP - eng.lookback, end + STEP, grid,
                                        eng.lookback)
            torch.cuda.synchronize()
            fetch_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        A.group_by_tags(metas, [b"job"])
        group_s = time.perf_counter() - t0
        log(f"[database] of a warm query: M3Storage.fetch_grid (the plan's execution, its "
            f"readback included) {statistics.median(fetch_s) * 1e3:.1f} ms (median of 10); "
            f"group_by_tags over the {s} metas (host) {group_s * 1e3:.1f} ms")

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
        # the streamed path's host cost: the series' prescan (the host
        # codec library) and their assembly
        live_streams = [streams[stream_of[i]] for i in range(DB_LIVE_SERIES)]
        t0 = time.perf_counter()
        chunked.build_chunked(live_streams, k=CHUNK_K)
        prescan_s = time.perf_counter() - t0
        log(f"[database] eviction churn: resident_clear dropped {dropped}; the next scan of the "
            f"{DB_LIVE_SERIES} live series streamed with the same totals bit for bit, {n_readmit} "
            f"lanes re-admitted read-through, the scan after it resident again, and so is the "
            f"scan of the block; the prescan alone (build_chunked: the library's prescan "
            f"and assemble_chunked) of those "
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
            first = ("cold (the plan's build)" if routing[fn].plan_misses
                     else "first run (a plan hit: the query before built the plan)")
            log(f"[database] end to end {q} over M3Storage: plan-served warm "
                f"{e2e[fn] * 1e3:.1f} ms (median of 10), {first} {cold[fn] * 1e3:.1f} ms, "
                f"force-staged {staged[fn] * 1e3:.1f} ms (one run); host clock, each ending in a "
                f"host copy")
        log(f"[database] end to end scan_totals of m3_scan over {s} series: resident "
            f"{statistics.median(res_s) * 1e3:.1f} ms (median of 3); streamed over the "
            f"{DB_LIVE_SERIES} live series {streamed_s * 1e3:.1f} ms (one run, the re-admission "
            f"of {n_readmit} lanes included), over both blocks {both_s * 1e3:.1f} ms (one run)")
        log(f"[database] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        phase_admission(dev, db, queries, start, end)
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
    kernels.append({
        "name": "consolidate_grid",
        "route": "cuda",
        "source": "m3_tpu_torch/query/csrc/consolidate_grid.cu",
        "replaces": "m3_tpu/query/plan.py:360",
        "launches": launches["consolidate_grid"],
        "max_abs_err": 0.0,
        "ms": b1_query["ms"],
        "plain_ms": b1_query["plain_ms"],
        "bound_ms": b1_query["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": b1_query["floor_ms"],
    })


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# [admission]: tenants, their threads, the queries each thread repeats, and
# noisy's series ceiling (below the queries' 100,000 matched series)
ADMISSION_TENANTS = ("alpha", "beta", "noisy")
ADMISSION_THREADS, ADMISSION_REPEATS, NOISY_MAX_SERIES = 12, 6, 1_000


def phase_admission(dev, db, queries: dict, start: int, end: int) -> None:
    import threading

    import torch

    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.ops import chunked, fused
    from m3_tpu_torch.parallel import scan
    from m3_tpu_torch.profiling import StackSampler, collect_device_memory, default_hz
    from m3_tpu_torch.query import engine as E
    from m3_tpu_torch.query import plan as qplan
    from m3_tpu_torch.query import scheduler as S
    from m3_tpu_torch.query import stats, tenants
    from m3_tpu_torch.query.cost import QueryLimitError, QueryLimits
    from m3_tpu_torch.query.functions import temporal_fused as TF
    from m3_tpu_torch.query.m3_storage import M3Storage
    from m3_tpu_torch.utils.instrument import DEFAULT as METRICS
    from m3_tpu_torch.utils.instrument import Registry

    t_phase = time.perf_counter()
    card = card_line()
    profs = (qplan.PROF, TF._JIT, IK.PROFILER, fused.PROFILER_PACKED, fused.PROFILER_FUSED,
             chunked.PROFILER, scan.RESIDENT_CHUNKED_PROF)
    # the plain engine's results, and the admission engine's plans warmed
    plain = E.Engine(M3Storage(db, "m3"), device=dev)
    want = {fn: plain.query_range(q, start, end, STEP) for fn, q in queries.items()}
    sched = S.QueryScheduler(max_inflight=2, max_queue=8)
    enforcers = tenants.TenantEnforcers({"noisy": QueryLimits(max_series=NOISY_MAX_SERIES)})
    eng = E.Engine(M3Storage(db, "m3"), scheduler=sched, tenant_enforcers=enforcers, device=dev)
    for q in queries.values():
        eng.query_range(q, start, end, STEP)

    def hist_sums():
        fam = METRICS.collect()["m3tpu_kernel_dispatch_seconds"]["children"]
        return {c["labels"]["kernel"]: c["sum"] for c in fam}

    def shed_counts():
        fam = METRICS.collect().get("m3tpu_query_shed_total", {"children": []})["children"]
        out = {}
        for c in fam:
            out[c["labels"]["reason"]] = out.get(c["labels"]["reason"], 0) + c["value"]
        return out

    ledger, ring = tenants.TenantLedger(max_tenants=16, registry=Registry(prefix="m3tpu_")), \
        stats.SlowQueryRing(4 * ADMISSION_THREADS * ADMISSION_REPEATS * len(queries))
    old = (tenants.LEDGER, stats.RING, [p.sample_rate for p in profs])
    tenants.LEDGER, stats.RING = ledger, ring
    sampler_reg = Registry(prefix="m3tpu_")
    sampler = StackSampler(hz=default_hz(), instance="admission", registry=sampler_reg)
    outcomes, errors = [], []
    try:
        for p in profs:
            p.sample_rate = 1.0
        n_samples = {p.kernel: len(p.device_samples) for p in profs}
        sums0, sheds0 = hist_sums(), shed_counts()
        barrier = threading.Barrier(ADMISSION_THREADS)

        def worker(i):
            tenant = ADMISSION_TENANTS[i % len(ADMISSION_TENANTS)]
            try:
                barrier.wait(30)
                with tenants.tenant_context(tenant):
                    for _ in range(ADMISSION_REPEATS):
                        for fn, q in queries.items():
                            try:
                                r = eng.query_range(q, start, end, STEP)
                                same = ([m.tags for m in r.metas] == [m.tags for m in want[fn].metas]
                                        and same_bits(r.values, want[fn].values))
                                outcomes.append((tenant, fn, "ok" if same else "differs"))
                            except QueryLimitError as exc:
                                outcomes.append((tenant, fn, f"limit:{exc.scope}"))
                            except S.QueryShedError as exc:
                                outcomes.append((tenant, fn, f"shed:{exc.reason}"))
            except Exception as exc:  # surfaced below
                errors.append(f"{tenant}: {type(exc).__name__}: {exc}")

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(ADMISSION_THREADS)]
        sampler.start()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        sampler.stop()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"[admission] threads failed: {errors[:3]}")
        sums1, sheds1 = hist_sums(), shed_counts()
        samples = {p.kernel: list(p.device_samples)[n_samples[p.kernel]:] for p in profs}
    finally:
        for p, r in zip(profs, old[2]):
            p.sample_rate = r
        tenants.LEDGER, stats.RING = old[0], old[1]
        sampler.stop()

    # 1. outcomes and their reconciliation
    total = ADMISSION_THREADS * ADMISSION_REPEATS * len(queries)
    kinds = {}
    for tenant, _fn, what in outcomes:
        kinds.setdefault(tenant, {}).setdefault(what, 0)
        kinds[tenant][what] += 1
    bad = [o for o in outcomes if not (
        o[2] == "ok" or (o[2] == "limit:tenant" and o[0] == "noisy")
        or (o[2].startswith("shed:") and o[2][5:] in (S.SHED_QUEUE_FULL, S.SHED_OVERLOAD,
                                                      S.SHED_DEADLINE)))]
    noisy_ok = kinds.get("noisy", {}).get("ok", 0)
    if len(outcomes) != total or bad or noisy_ok:
        raise AssertionError(f"[admission] outcomes: {len(outcomes)} of {total}, unexpected "
                             f"{bad[:3]}, noisy served {noisy_ok}")
    dump = {r["tenant"]: r["total"] for r in ledger.dump()["tenants"]}
    for tenant in ADMISSION_TENANTS:
        seen = kinds.get(tenant, {})
        n_limit = seen.get("limit:tenant", 0)
        n_shed = sum(v for k, v in seen.items() if k.startswith("shed:"))
        row = dump.get(tenant, {})
        if (row.get("queries"), row.get("limit_rejections"), row.get("sheds")) != (
                sum(seen.values()), n_limit, n_shed):
            raise AssertionError(f"[admission] ledger for {tenant}: {row} vs outcomes {seen}")
    by_reason = {}
    for _t, _fn, what in outcomes:
        if what.startswith("shed:"):
            by_reason[what[5:]] = by_reason.get(what[5:], 0) + 1
    counted = {k: v - sheds0.get(k, 0) for k, v in sheds1.items() if v - sheds0.get(k, 0)}
    if counted != by_reason:
        raise AssertionError(f"[admission] query_shed_total by reason {counted} != {by_reason}")
    if sched.snapshot()["inflight"] != 0:
        raise AssertionError(f"[admission] scheduler snapshot at the end: {sched.snapshot()}")
    # 2. dispatches per record: one query_plan (none when coalesced) and B2's
    records = ring.dump()
    if len(records) != total:
        raise AssertionError(f"[admission] {len(records)} records for {total} queries")
    wrong = []
    for r in records:
        plan = 0 if r["planCoalesced"] else 1
        if r["queueState"] == "shed":
            want_d = 0
        elif r["limitExceeded"]:
            want_d = plan
        else:
            want_d = plan + 1
            if r["planHits"] + r["planCoalesced"] != 1 or r["planFallbacks"]:
                wrong.append(r)
                continue
        if r["deviceDispatches"] != want_d:
            wrong.append(r)
    if wrong:
        raise AssertionError(f"[admission] device_dispatches off on {len(wrong)} records, e.g. "
                             f"{ {k: wrong[0][k] for k in ('tenant', 'queueState', 'planHits', 'planCoalesced', 'limitExceeded', 'deviceDispatches')} }")
    coalesced = sum(1 for r in records if r["planCoalesced"])
    # 3. device seconds: every sampled dispatch ran inside a tenant context
    decode = {t: dump.get(t, {}).get("decode_seconds", 0.0) for t in ADMISSION_TENANTS}
    hist = sum(v - sums0.get(k, 0.0) for k, v in sums1.items())
    if min(decode.values()) <= 0 or abs(sum(decode.values()) - hist) > 1e-9 * hist:
        raise AssertionError(f"[admission] tenants' decode_seconds {decode} (sum "
                             f"{sum(decode.values())!r}) vs the histograms' {hist!r}")
    log(f"[admission] {card}: {total} queries from {ADMISSION_THREADS} threads in {wall_s:.2f} s: "
        f"{ {t: kinds.get(t, {}) for t in ADMISSION_TENANTS} }; every served result == the plain "
        f"engine's bit for bit; ledger, query_shed_total ({by_reason}) and the outcomes agree; "
        f"{coalesced} coalesced records; in flight at the end 0")
    log(f"[admission] tenants' decode_seconds {({t: round(v, 6) for t, v in decode.items()})} sum "
        f"{sum(decode.values())!r} == the kernel_dispatch_seconds sums' change {hist!r}")
    for kernel, rows in samples.items():
        if rows:
            sec = statistics.median(r[0] for r in rows) * 1e3
            dev_ms = statistics.median(r[1] for r in rows)
            shares = [r[1] / (r[0] * 1e3) for r in rows]
            log(f"[admission] {card}: {kernel}: {len(rows)} sampled dispatches, median "
                f"{sec:.3f} ms observed (enter to the event waited on) beside a median "
                f"{dev_ms:.3f} ms between the same dispatches' CUDA events; a dispatch's "
                f"event span is a median {statistics.median(shares):.1%} of what it observed "
                f"(at most {max(shares):.1%})")
    # 4. a warm query's latency at sample_rate 0 and 1, in turns
    q = queries["rate"]
    lat = {0.0: [], 1.0: []}
    try:
        for rate in (0.0, 1.0, 1.0, 0.0) * 3:
            for p in profs:
                p.sample_rate = rate
            t0 = time.perf_counter()
            eng.query_range(q, start, end, STEP).values.cpu()
            lat[rate].append(time.perf_counter() - t0)
    finally:
        for p, r in zip(profs, old[2]):
            p.sample_rate = r
    log(f"[admission] {card}: a warm {q} end to end, median of 6 in turns: sample_rate 0 "
        f"{statistics.median(lat[0.0]) * 1e3:.1f} ms, sample_rate 1 "
        f"{statistics.median(lat[1.0]) * 1e3:.1f} ms (host clock)")
    # 5. the device-memory split and the sampler
    mem = collect_device_memory(db)
    if (mem["resident_pool"] != db.resident_pool.device_bytes()
            or mem["index"] != db.index_device_store.device_bytes()
            or mem["total_live_jax_bytes"] < mem["resident_pool"] + mem["index"]):
        raise AssertionError(f"[admission] collect_device_memory: {mem}")
    prof = sampler.profile()
    in_query = sum(n for st, n in prof["folded"].items() if "engine.py:query_range" in st)
    err = sum(c["value"] for c in sampler_reg.collect()["m3tpu_profile_errors_total"]["children"])
    if err or not prof["samples"]:
        raise AssertionError(f"[admission] sampler: {prof['samples']} samples, {err} errors")
    log(f"[admission] {card}: collect_device_memory(db) {mem}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()}")
    log(f"[admission] StackSampler at {default_hz():g} Hz during the threads: {prof['samples']} "
        f"stack samples, {in_query / prof['samples']:.1%} inside Engine.query_range, "
        f"0 errors; phase {time.perf_counter() - t_phase:.1f} s")


# [promql]: the queries, each with the scope of its check against the CPU
# engine: all 100,000 series where the CPU finishes within a minute, else
# the fan-out matcher's 11,111 (the twins of predict_linear at W = 361 and
# holt_winters at W = 61 take longer on 8 cores; 99 s for holt_winters on
# the card's host, PERF.md)
PROMQL_QUERIES = [
    ("predict_linear", "predict_linear({sel}[1h], 14400) < 0", "fan-out"),
    ("deriv", "deriv({sel}[5m])", "all"),
    ("holt_winters", "holt_winters({sel}[10m], 0.3, 0.6)", "fan-out"),
    ("quantile_over_time", "quantile_over_time(0.99, {sel}[5m])", "all"),
    ("group_left", "rate({sel}[1m]) / on(job) group_left sum by (job) (rate({sel}[1m]))", "all"),
    ("topk", "topk(5, rate({sel}[1m]))", "all"),
    ("quantile", "quantile by (job) (0.9, rate({sel}[1m]))", "all"),
    ("subquery", "max_over_time(rate({sel}[1m])[10m:1m])", "all"),
    ("at", "{sel} @ end()", "all"),
]
FANOUT_SEL = 'm3_scan{host=~"h1.*"}'
# B-7 at the phase's windows: (function, window, parameters)
B7_RUNS = [("predict_linear", 361, (14400.0,)), ("deriv", 31, ()),
           ("holt_winters", 61, (0.3, 0.6)), ("quantile_over_time", 31, (0.99,))]
# The fewest f32 adds, multiplies and divisions B-7's parity contract
# leaves, counted over the windows that compute a value: (a valid slot of a
# window holding its samples in one run at its end, a valid slot of any
# other window, each such window's own, the samples a window needs to
# compute a value). The linear functions: 3 a slot (sum v, d*v and its add:
# sum d and sum d^2 are the same fold in every such window, a table entry)
# or 7 (n, sum v, sum d, d*d and its add, d*v and its add); a window's
# slope is 7 (cov 3, var 3, their quotient), predict_linear's intercept 4
# and prediction 2 more. holt_winters: trend 4 and level 4 a slot, but
# nothing on a window's first sample and 5 on its second (x - curr, then
# the level), 8n - 11. The quantile: one comparison a value, and the
# interpolation's 5 a window.
B7_OPS = {"predict_linear": (3, 7, 13, 2), "deriv": (3, 7, 7, 2), "holt_winters": (8, 8, -11, 2),
          "quantile_over_time": (1, 1, 5, 1)}


class CpuGrid:
    """A storage adapter handing the CPU engine a CPU copy of the card
    storage's fetched grid."""

    def __init__(self, storage):
        self.storage = storage

    def fetch_grid(self, matchers, start, end, grid, lookback):
        metas, values, datapoints = self.storage.fetch_grid(matchers, start, end, grid, lookback)
        return metas, values.cpu(), datapoints

    def fetch(self, matchers, start, end):
        raise AssertionError("the CPU check runs on the card's fetched grid only")


def compare_results(got, want, what: str) -> float:
    """Card result vs the CPU engine's: metas, dtype and NaN pattern equal,
    infinities equal, values within 1e-4 abs + 1e-4 rel. Returns the
    largest absolute difference."""
    import torch

    if [m.tags for m in got.metas] != [m.tags for m in want.metas] or got.scalar != want.scalar:
        raise AssertionError(f"{what}: metas differ from the CPU engine's")
    g, w = got.values.cpu(), want.values
    if g.dtype != w.dtype or g.shape != w.shape:
        raise AssertionError(f"{what}: {g.dtype} {tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
    if not torch.equal(g.isnan(), w.isnan()) or not torch.equal(g[w.isinf()], w[w.isinf()]):
        raise AssertionError(f"{what}: NaN or infinity pattern differs from the CPU engine's")
    ok = ~w.isnan() & ~w.isinf()
    diff = (g[ok].double() - w[ok].double()).abs()
    if bool((diff > 1e-4 + 1e-4 * w[ok].double().abs()).any()):
        raise AssertionError(f"{what}: {int((diff > 1e-4).sum())} values beyond 1e-4 abs + rel")
    return float(diff.max()) if diff.numel() else 0.0


def b7_window_slots(x, window: int, first: int, least: int) -> tuple[int, int, int]:
    """Over the windows of output columns first .. T-1 of x [S, T] that hold
    at least `least` samples: their valid samples summed, the samples of
    those that hold theirs in one run at the window's end (a fully valid
    window included), and the windows."""
    import torch

    rows, cols = x.shape
    p = torch.nn.functional.pad((~x.isnan()).to(torch.int32).cumsum(1, dtype=torch.int32),
                                (1, 0))  # p[:, i]: samples in columns [0, i)
    t = torch.arange(first, cols, device=x.device)
    lo, hi = (t - window + 1).clamp(min=0), t + 1
    n = p[:, hi] - p[:, lo]
    at_end = p[:, hi] - p.gather(1, (hi[None, :] - n).long()) == n
    n = n.to(torch.int64)
    counted = n >= least
    return int(n[counted].sum()), int(n[counted & at_end].sum()), int(counted.sum())


def b7_bound(x, name: str, window: int, first: int) -> dict:
    """B-7's bound over the kept columns of x: bytes (the input read once,
    the output written once) at 3.35 TB/s, B7_OPS's operations at 67 TFLOP/s
    and, beside it, at the no-FMA 33.5 TFLOP/s."""
    rows, cols = x.shape
    nbytes = (rows * cols + rows * (cols - first)) * 4
    few, many, each, least = B7_OPS[name]
    slots, run_slots, windows = b7_window_slots(x, window, first, least)
    ops = run_slots * few + (slots - run_slots) * many + windows * each
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "slots": slots, "run_slots": run_slots,
            "windows": windows, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # adds and multiplies without FMA: one a lane a cycle
            "no_fma_ceiling_ms": max(bytes_ms, 2 * ops_ms)}


def b7_bound_text(bd: dict, name: str) -> str:
    few, many, each, least = B7_OPS[name]
    return (f"bound {bd['bound_ms']:.3f} ms = max(bytes {bd['bytes_ms']:.3f} ms: "
            f"{bd['bytes'] / 1e9:.3f} GB at 3.35 TB/s, operations {bd['ops_ms']:.3f} ms: "
            f"{bd['slots']} valid slots of the {bd['windows']} kept windows with >= {least} "
            f"samples, {bd['run_slots']} of them in windows holding their samples in one run at "
            f"the end, x {few} (those) / {many} (the rest) {each:+d} a window = {bd['ops']} f32 "
            f"operations at 67 TFLOP/s); no-FMA ceiling (the operations at 33.5 TFLOP/s, "
            f"-fmad=false) {bd['no_fma_ceiling_ms']:.3f} ms")


def b7_turns(parent, x, name: str, window: int, first: int, args, iters: int = 10,
             b2b: int = 20) -> list:
    """The parent commit's B-7 (every column, what the engine's call cost
    before) and this one's (the kept columns) in turns (parent, new, new,
    parent) on the same input, each through its C entry into an output
    allocated once: a median of `iters` single launches and a back-to-back
    run of `b2b` (CUDA events). The parent's kept columns must equal this
    one's bit for bit."""
    import torch

    from m3_tpu_torch.ops._build import load_library
    from m3_tpu_torch.query.functions import temporal_window as TW

    rows, cols = x.shape
    fid, params = TW._FN_ID[name], TW._params(name, STEP / 1e9, args)
    new = load_library("temporal_window")
    stream = torch.cuda.current_stream().cuda_stream
    outs = {"parent": torch.empty_like(x), "new": x.new_empty((rows, cols - first))}
    sizes = {"parent": parent.m3_temporal_window_scratch_bytes(rows, cols, window, fid, 0, 0),
             "new": new.m3_temporal_window_scratch_bytes(rows, cols, window, first, fid, 0, 0)}
    scratch = {k: torch.empty(max(n // 4, 1), dtype=torch.float32, device=x.device)
               for k, n in sizes.items()}

    def call(who):
        o, sc, n = outs[who].data_ptr(), scratch[who].data_ptr(), sizes[who]
        if who == "parent":
            rc = parent.m3_temporal_window(x.data_ptr(), rows, cols, window, fid, *params, 0, 0,
                                           o, sc, n, stream)
        else:
            rc = new.m3_temporal_window(x.data_ptr(), rows, cols, window, first, fid, *params, 0,
                                        0, o, sc, n, stream)
        if rc != 0:
            raise RuntimeError(f"the {who} B-7 launch failed: CUDA error {rc}")

    return in_turns(call, lambda: same_bits(outs["parent"][:, first:].contiguous(), outs["new"]),
                    f"B-7 {name}", iters, b2b)


def b7_quantile_long(x, parent_b7=None) -> dict:
    """quantile_over_time(0.99, m3_scan[1h]) as the engine calls it
    (first = W - 1) on the W = 361 grid x, whose series start inside the
    first windows, and on the same grid with its first 360 columns a copy
    of columns 360 .. 719 (every window full: series with an hour of
    history): == the twin on the card bit for bit, timed at the kernel's
    layout and at runs of 23, 45, 90, 180 and 360 columns a lane, beside
    the bound; and the parent's B-7 in turns."""
    import torch

    from m3_tpu_torch.query.functions import temporal as T
    from m3_tpu_torch.query.functions import temporal_window as TW

    name, window, args = "quantile_over_time", 361, (0.99,)
    first = window - 1
    grids = {"series start inside": x,
             "full windows": torch.cat([x[:, first:2 * first], x[:, first:]], dim=1)}
    out = {}
    for label, g in grids.items():
        rows, cols = g.shape
        want = T.quantile_over_time(g, window, args[0], chunk=16)[:, first:]
        bd = b7_bound(g, name, window, first)
        res = {"bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"], "runs": {}}
        for run in (0, 23, 45, 90, 180, 360):
            f = lambda run=run: TW.temporal_window(name, g, window, STEP / 1e9, *args,
                                                   first=first, run=run)
            if not same_bits(f(), want):
                raise AssertionError(f"B-7 {name} w={window} run={run} ({label}) differs from "
                                     f"its twin on the card")
            sh = TW.launch_shape(name, rows, cols, window, first=first, run=run)
            ms = statistics.median(cuda_ms(f, 5))
            res["runs"][run] = (ms, per_launch_ms(f, 5), sh)
        log(f"[promql] B-7 {name} w={window} first={first} [{rows}, {cols}] ({label}; == twin "
            f"bit for bit on all {rows} rows): {b7_bound_text(bd, name)}; by run (0: the "
            f"kernel's), median of 5 [back to back]: "
            + "; ".join(f"run {r} ({sh['run']} columns, {sh['lanes_per_row']} lanes a row, "
                        f"{sh['rows_per_warp']} rows a warp, {sh['threads']} threads, "
                        f"{sh['blocks']} blocks, {sh['smem_bytes']} B): {a:.3f} [{b:.3f}] ms = "
                        f"{bd['bound_ms'] / a:.1%}"
                        for r, (a, b, sh) in res["runs"].items()))
        if parent_b7 is not None:
            turns = b7_turns(parent_b7, g, name, window, first, args, iters=3, b2b=3)
            res["parent_turns"] = turns
            log(f"[promql] B-7 {name} w={window} ({label}) in turns, the parent (every column) "
                f"and this one (the kept columns), median of 3 [back to back]: "
                + ", ".join(f"{who} {a:.3f} [{c:.3f}]" for who, a, c in turns) + " ms")
        res["runs"] = {r: (a, b) for r, (a, b, _) in res["runs"].items()}
        out[label] = res
        del want
    return out


def b7_e2e_turns(eng, queries: dict, start: int, end: int, parent) -> None:
    """[promql]'s four B-7 queries end to end (host clock, ending in a host
    copy, median of 10) with this B-7 and with the parent's swapped into the
    wrapper (it computes every column, the engine then keeps its W-1 on, as
    before), in turns (new, parent, parent, new), and the device time of
    each (torch.profiler)."""
    import torch

    from m3_tpu_torch.query.functions import temporal_window as TW

    own = TW._launch

    def parent_launch(name, v, window, first, params, run, force_global):
        rows, cols = v.shape
        fid = TW._FN_ID[name]
        out = torch.empty_like(v)
        nb = parent.m3_temporal_window_scratch_bytes(rows, cols, window, fid, run,
                                                     int(force_global))
        scratch = torch.empty(max(nb // 4, 1), dtype=torch.float32, device=v.device)
        rc = parent.m3_temporal_window(v.data_ptr(), rows, cols, window, fid, *params, run,
                                       int(force_global), out.data_ptr(), scratch.data_ptr(), nb,
                                       torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's B-7 launch failed: CUDA error {rc}")
        return out[:, first:]

    for label, q in queries.items():
        turns = []
        for who in ("new", "parent", "parent", "new"):
            TW._launch = parent_launch if who == "parent" else own
            try:
                times = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    eng.query_range(q, start, end, STEP).values.cpu()
                    times.append(time.perf_counter() - t0)
                prof = profiled(lambda q=q: eng.query_range(q, start, end, STEP).values.cpu())
            finally:
                TW._launch = own
            turns.append(f"{who} {statistics.median(times) * 1e3:.3f} ms (device "
                         f"{prof['device_ms']:.3f})")
        log(f"[promql] end to end in turns, this B-7 and the parent's: {q}: " + ", ".join(turns))


def b7_times(storage, lookback: int, b7_by_query: dict, parent_b7=None) -> dict:
    """B-7 as the engine calls it (the kept columns, first = W - 1) on the
    grids of [promql]'s four windowed queries: == its twin on the card
    sliced at first, bit for bit on every row, timed beside its bound, the
    no-FMA ceiling, the twin and the library yardstick (and the
    parent's B-7 in turns)."""
    import torch

    from m3_tpu_torch.block.core import Bounds
    from m3_tpu_torch.query.functions import temporal_window as TW
    from m3_tpu_torch.query.promql import Matcher

    start = T0
    b7 = {}
    matchers = [Matcher("__name__", "=", "m3_scan")]
    for name, window, args in B7_RUNS:
        b = Bounds(start - (window - 1) * STEP, STEP, N_POINTS + window - 1)
        _, values, _ = storage.fetch_grid(matchers, b.start_nanos - lookback,
                                          start + STEP * N_POINTS, b.timestamps(), lookback)
        x = values.to(torch.float32)
        first = window - 1
        run = lambda x=x, name=name, window=window, args=args, first=first: TW.temporal_window(
            name, x, window, STEP / 1e9, *args, first=first)
        got = run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = TW.FUNCTIONS[name](x, window, STEP / 1e9, *args)[:, first:]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not same_bits(got, want):
            raise AssertionError(f"B-7 {name} w={window} differs from its twin on the card")
        ms = statistics.median(cuda_ms(run, 10))
        b2b = per_launch_ms(run)
        rows, cols = x.shape
        n_out = cols - first
        bd = b7_bound(x, name, window, first)
        lib_ms = None
        lib_note = "none: no PyTorch call computes it"
        if name == "quantile_over_time":
            lib = lambda: x.unfold(1, window, 1).nanquantile(args[0], dim=-1)
            lib_out = lib()
            lib_ms = statistics.median(cuda_ms(lib, 5))
            ok = ~want.isnan()
            lib_diff = float((lib_out[ok] - want[ok]).abs().max())
            same_nan = bool(torch.equal(lib_out.isnan(), want.isnan()))
            lib_note = (f"unfold(1, {window}, 1).nanquantile({args[0]}, dim=-1) over the kept "
                        f"columns' windows {lib_ms:.3f} ms (median of 5): torch.lerp's "
                        f"interpolation (max abs diff {lib_diff:.3g} vs B-7, NaN pattern "
                        f"{'equal' if same_nan else 'NOT equal'}), and no -inf/+inf for q "
                        f"outside [0, 1] (it raises)")
            del lib_out
        shape = TW.launch_shape(name, rows, cols, window, first=first)
        b7[name] = {"window": window, "first": first, "ms": ms, "b2b": b2b,
                    "plain_ms": plain_ms, "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                    "no_fma_ceiling_ms": bd["no_fma_ceiling_ms"], "library_ms": lib_ms}
        log(f"[promql] B-7 (temporal_window) {name} [{rows}, {cols}] w={window} first={first} "
            f"-> [{rows}, {n_out}]: {ms:.3f} ms (median of 10, CUDA events; back-to-back "
            f"{b2b:.3f} ms); {b7_bound_text(bd, name)}; shares {bd['bound_ms'] / ms:.1%} and "
            f"{bd['no_fma_ceiling_ms'] / ms:.1%}; {b7_by_query[name]} launch on the path (its "
            f"query's); twin on the card {plain_ms:.1f} ms; == twin bit for bit on all {rows} "
            f"rows; launch {shape}; library: {lib_note}")
        if name == "quantile_over_time":
            sweep = {}
            for r in (23, 45, 90, 180):
                f = lambda r=r: TW.temporal_window(name, x, window, STEP / 1e9, *args,
                                                   first=first, run=r)
                if not same_bits(f(), want):
                    raise AssertionError(f"B-7 {name} run={r} differs from its twin on the card")
                sweep[r] = (statistics.median(cuda_ms(f, 10)), per_launch_ms(f),
                            TW.launch_shape(name, rows, cols, window, first=first, run=r))
            b7[name]["runs"] = {r: t[:2] for r, t in sweep.items()}
            log("[promql] B-7 quantile_over_time by run (columns a lane; == twin bit for bit): "
                + "; ".join(f"run {r}: {a:.3f} [{c:.3f}] ms, {sh['lanes_per_row']} lanes a row, "
                            f"{sh['rows_per_warp']} rows a warp, {sh['threads']} threads, "
                            f"{sh['blocks']} blocks, {sh['smem_bytes']} B"
                            for r, (a, c, sh) in sweep.items()))
        if window == 361:
            b7[name]["quantile_w361"] = b7_quantile_long(x, parent_b7)
        if parent_b7 is not None:
            turns = b7_turns(parent_b7, x, name, window, first, args)
            b7[name]["parent_turns"] = turns
            log(f"[promql] B-7 {name} in turns, the parent (every column) and this one (the "
                f"kept columns), C entries on the same input, median of 10 [back to back]: "
                + ", ".join(f"{who} {a:.3f} [{c:.3f}]" for who, a, c in turns) + " ms")
        del x, values, got, want
    for kernel in ("window_staged_kernel", "quantile_staged_kernel", "window_global_kernel"):
        log(f"[promql] ptxas: {ptxas_report('temporal_window', kernel)}")
    return b7


def phase_promql(dev, kernels: list, storage, parent_b7=None) -> None:
    import torch

    from m3_tpu_torch.block.core import Bounds
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.ops import chunked
    from m3_tpu_torch.query import engine as E
    from m3_tpu_torch.query import plan as qplan
    from m3_tpu_torch.query.functions import aggregation as A
    from m3_tpu_torch.query.functions import temporal_fused as TF
    from m3_tpu_torch.query.functions import temporal_window as TW
    from m3_tpu_torch.query.promql import Matcher

    t_phase = time.perf_counter()
    eng = E.Engine(storage, device=dev)
    start, end = T0, T0 + (N_POINTS - 1) * STEP
    full = {label: q.format(sel="m3_scan") for label, q, _ in PROMQL_QUERIES}

    # the main path, counted: every query once
    counts = {"temporal_window": TW, "temporal_fused": TF, "grouped_reduce": A,
              "consolidate_grid": qplan, "decode_records": chunked}
    for mod in counts.values():
        mod.LAUNCHES = 0
    for k in IK.LAUNCHES:
        IK.LAUNCHES[k] = 0
    results, b7_by_query = {}, {}
    for label, q in full.items():
        before = TW.LAUNCHES
        results[label] = eng.query_range(q, start, end, STEP)
        b7_by_query[label] = TW.LAUNCHES - before
    torch.cuda.synchronize()
    launches = {name: mod.LAUNCHES for name, mod in counts.items()}
    launches.update({"index_match_terms": IK.LAUNCHES["match_terms"],
                     "index_bitmap": IK.LAUNCHES["bitmap_from_spans"]})
    log(f"[promql] launches on the main path ({len(full)} queries): {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"[promql] the path did not launch {name}")
    want_b7 = {label: int(label in TW.FUNCTIONS) for label in full}
    if b7_by_query != want_b7:
        raise AssertionError(f"[promql] B-7 launches by query {b7_by_query}, want {want_b7}")

    # each query against the CPU engine over a CPU copy of the card's grid
    cpu_eng = E.Engine(CpuGrid(storage), device="cpu")
    for label, q, scope in PROMQL_QUERIES:
        if scope == "all":
            card, text = results[label], full[label]
        else:
            text = q.format(sel=FANOUT_SEL)
            card = eng.query_range(text, start, end, STEP)
        t0 = time.perf_counter()
        want = cpu_eng.query_range(text, start, end, STEP)
        cpu_s = time.perf_counter() - t0
        err = compare_results(card, want, text)
        finite = int((~card.values.isnan()).sum())
        log(f"[promql] {text}: [{card.values.shape[0]}, {card.values.shape[1]}] "
            f"{str(card.values.dtype).split('.')[-1]}, {finite} non-NaN, == the CPU engine on "
            f"{'all' if scope == 'all' else 'the fan-out matcher' + chr(39) + 's'} "
            f"{len(card.metas) if scope == 'all' or 'topk' in q else len(want.metas)} series "
            f"(metas, NaN pattern, max abs diff {err:.3g}; CPU {cpu_s:.1f}s)")
    log("[promql] predict_linear and holt_winters are checked on the fan-out matcher's series: "
        "their twins take over a minute on the CPU at 100,000 series (B-7 == its twin on the "
        "card on every row below)")

    # per query: the host clock end to end (median of 10) and the device time
    for label, q in full.items():
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.query_range(q, start, end, STEP).values.cpu()
            times.append(time.perf_counter() - t0)
        prof = profiled(lambda q=q: eng.query_range(q, start, end, STEP).values.cpu(), top=3)
        shape = tuple(results[label].values.shape)
        log(f"[promql] end to end {q}: {statistics.median(times) * 1e3:.3f} ms (median of 10, "
            f"host clock, ending in a host copy; {list(shape)}); device time "
            f"{prof['device_ms']:.3f} ms of {prof['wall_ms']:.3f} ms (torch.profiler), the most: "
            + ", ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    if parent_b7 is not None:
        b7_e2e_turns(eng, {label: full[label] for label in TW.FUNCTIONS}, start, end, parent_b7)
    b7 = b7_times(storage, eng.lookback, b7_by_query, parent_b7)
    check_no_unaligned_copies("promql")
    log(f"[promql] phase {time.perf_counter() - t_phase:.1f}s")
    main = b7["predict_linear"]
    kernels.append({
        "name": "temporal_window",
        "route": "cuda",
        "source": "m3_tpu_torch/query/functions/csrc/temporal_window.cu",
        "replaces": "m3_tpu/query/functions/temporal.py:419",
        "launches": launches["temporal_window"],
        "max_abs_err": 0.0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "functions": b7,
    })


def config4_points(n_series: int, seed: int = 2):
    """BASELINE config 4's datapoints as bench_suite.py builds them: AGG_POINTS
    a series at 10 s spacing with a random offset inside each 10 s, all in
    the minute from AGG_T0, lognormal values. (ids i64, times i64, values
    f32), series-major."""
    n = n_series * AGG_POINTS
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(n_series, dtype=np.int64), AGG_POINTS)
    times = (AGG_T0 + np.tile(np.arange(AGG_POINTS, dtype=np.int64) * 10 * 10**9, n_series)
             + rng.integers(0, 10 * 10**9, n))
    return ids, times, rng.lognormal(0, 1, n).astype(np.float32)


def wide_shard(batch: int, seed: int = 3):
    """One shard of the end-to-end flush in which a timer batched `batch`
    values into the window: config 4's points for AGG_SHARD_ROWS series
    plus the timer's, densified as `_flush_policy` densifies them. (vals,
    torder, valid) [AGG_SHARD_ROWS + 1, batch]."""
    from m3_tpu_torch.aggregator import kernels as K

    rng = np.random.default_rng(seed)
    ids, times, values = config4_points(AGG_SHARD_ROWS)
    ids = np.concatenate([ids, np.full(batch, AGG_SHARD_ROWS, np.int64)])
    times = np.concatenate([times, AGG_T0 + rng.integers(0, 60 * 10**9, batch)])
    values = np.concatenate([values, rng.lognormal(0, 1, batch).astype(np.float32)])
    keys, _, torder = K.window_keys(ids, times, AGG_T0, 60 * 10**9, 1)
    return K.pack_dense_groups(keys, values, torder, AGG_SHARD_ROWS + 1)


def timer_shard(batch: int, seed: int = 4):
    """One shard of the end-to-end flush in which every timer (one series
    in ten, as in the flush) batched `batch` values into the window
    instead of AGG_POINTS, densified as `_flush_policy` densifies them.
    (vals, torder, valid) [AGG_SHARD_ROWS, batch]."""
    from m3_tpu_torch.aggregator import kernels as K

    rng = np.random.default_rng(seed)
    ids, times, values = config4_points(AGG_SHARD_ROWS)
    extra = np.repeat(np.arange(0, AGG_SHARD_ROWS, 10, dtype=np.int64), batch - AGG_POINTS)
    ids = np.concatenate([ids, extra])
    times = np.concatenate([times, AGG_T0 + rng.integers(0, 60 * 10**9, len(extra))])
    values = np.concatenate([values, rng.lognormal(0, 1, len(extra)).astype(np.float32)])
    keys, _, torder = K.window_keys(ids, times, AGG_T0, 60 * 10**9, 1)
    return K.pack_dense_groups(keys, values, torder, AGG_SHARD_ROWS)


def rollup_times(run, twin, bound_ms: float, library=None) -> dict:
    """A rollup kernel's time (median of 10 single launches, CUDA events),
    back to back, its twin's and the library call's, beside its bound."""
    out = {"ms": statistics.median(cuda_ms(run, 10)), "b2b": per_launch_ms(run),
           "plain_ms": statistics.median(cuda_ms(twin, 3)), "bound_ms": bound_ms,
           "library_ms": None if library is None else statistics.median(cuda_ms(library, 5))}
    out["share"] = bound_ms / out["ms"]
    return out


def phase_aggregator(dev, kernels: list, parent_b5=None) -> None:
    """The aggregator tier: B-5a and B-5b at BASELINE config 4's full size
    (and in turns with the parent's, given ``parent_b5``), the Aggregator
    end to end at a tenth of it, and the Downsampler."""
    import copy
    import itertools

    import torch

    from m3_tpu_torch.aggregator import kernels as K
    from m3_tpu_torch.aggregator.aggregator import Aggregator
    from m3_tpu_torch.aggregator.downsampler import Downsampler
    from m3_tpu_torch.block.core import make_tags
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.metrics.policy import StoragePolicy
    from m3_tpu_torch.metrics.types import AggregationType, MetricType, Untimed
    from m3_tpu_torch.rules.filters import TagsFilter
    from m3_tpu_torch.rules.rules import (MappingRule, RollupRule, RollupTarget, RuleSet,
                                          TransformationType)

    t_phase = time.perf_counter()
    minute = 60 * 10**9
    floor_ms = statistics.median(cuda_ms(lambda: IK.launch_floor(dev), 20))
    floor_b2b = per_launch_ms(lambda: IK.launch_floor(dev))
    log(f"[aggregator] launch floor (an empty kernel) {floor_ms:.4f} ms [{floor_b2b:.4f}]")
    turns = {}  # the parent's B-5a / B-5b in turns with these, by input
    # 1. the kernels at config 4's full width
    ids, times, values = config4_points(AGG_SERIES)
    t0 = time.perf_counter()
    keys, _, torder = K.window_keys(ids, times, AGG_T0, minute, 1)
    vals, tor, valid = K.pack_dense_groups(keys, values, torder, AGG_SERIES)
    densify_s = time.perf_counter() - t0
    del ids, times, values, keys, torder
    if vals.shape != (AGG_SERIES, AGG_POINTS) or not valid.all():
        raise AssertionError(f"config 4 densified to {vals.shape}, want [{AGG_SERIES}, 6] full")
    log(f"[aggregator] config 4: {AGG_SERIES:,} series x {AGG_POINTS} points into one 1 m "
        f"window; host densify (window_keys + pack_dense_groups) {densify_s:.3f} s")
    v, t, ok = (torch.from_numpy(a).to(dev) for a in (vals, tor, valid))
    del vals, tor, valid
    g, p = v.shape
    got = K.aggregate_dense_fields(v, t, ok)
    if not same_bits(got, K.aggregate_dense_reference(v, t, ok)):
        raise AssertionError("B-5a differs from its twin at config 4's full size")
    if not torch.equal(got[1].cpu(), torch.full((g,), float(p))):
        raise AssertionError("B-5a's counts are not config 4's 6 a group")
    b5a_bytes = g * p * (4 + 4 + 1) + len(K.FIELDS) * g * 4
    b5a = rollup_times(lambda: K.launch_aggregate_dense(v, t, ok),
                       lambda: K.aggregate_dense_reference(v, t, ok),
                       b5a_bytes / HBM_BYTES_PER_S * 1e3)
    log(f"[aggregator] B-5a [{g:,}, {p}] -> [8, {g:,}]: {b5a['ms']:.3f} ms [{b5a['b2b']:.3f}] "
        f"(CUDA events; == twin bit for bit), bound {b5a['bound_ms']:.3f} ms (bytes: "
        f"{b5a_bytes / 1e6:.0f} MB at 3.35 TB/s, {b5a['share']:.1%}), launch floor "
        f"{floor_ms:.4f} ms, twin on the card {b5a['plain_ms']:.3f} ms, library none")
    if parent_b5 is not None:
        key = f"aggregate_dense [{g:,}, {p}]"
        turns[key] = b5_turns(parent_b5, v, t, ok)
        log(f"[aggregator] B-5a [{g:,}, {p}] in turns (ms [back to back]): {fmt_turns(turns[key])}")
    b5b = {}
    for what, rows in (("timer slice", AGG_SERIES // 10), ("all groups", AGG_SERIES)):
        vq, okq = v[:rows], ok[:rows]
        if not same_bits(K.dense_quantiles(vq, okq, AGG_QS),
                         K.dense_quantiles_reference(vq, okq, AGG_QS)):
            raise AssertionError(f"B-5b differs from its twin over the {what}")
        qt = torch.tensor(AGG_QS, dtype=torch.float32, device=dev)
        lib = torch.nanquantile(vq, qt, dim=1, interpolation="linear")
        lib_err = float((lib - K.dense_quantiles(vq, okq, AGG_QS)).abs().max())
        nbytes = rows * p * (4 + 1) + len(AGG_QS) * rows * 4
        b5b[what] = rollup_times(
            lambda: K.launch_dense_quantiles(vq, okq, AGG_QS),
            lambda: K.dense_quantiles_reference(vq, okq, AGG_QS),
            nbytes / HBM_BYTES_PER_S * 1e3,
            lambda: torch.nanquantile(vq, qt, dim=1, interpolation="linear"))
        r = b5b[what]
        log(f"[aggregator] B-5b {what} [{rows:,}, {p}] -> [{len(AGG_QS)}, {rows:,}] "
            f"p50/p95/p99: {r['ms']:.3f} ms [{r['b2b']:.3f}] (== twin bit for bit), bound "
            f"{r['bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.0f} MB, {r['share']:.1%}), launch "
            f"floor {floor_ms:.4f} ms, twin {r['plain_ms']:.3f} ms, torch.nanquantile "
            f"{r['library_ms']:.3f} ms (max abs {lib_err:.3g} from B-5b: lerp's rounding)")
        if parent_b5 is not None:
            key = f"dense_quantiles {what} [{rows:,}, {p}]"
            turns[key] = b5_turns(parent_b5, vq, None, okq, AGG_QS)
            log(f"[aggregator] B-5b {what} in turns: {fmt_turns(turns[key])}")
    del v, t, ok, got, vq, okq, lib
    # a shard widened by one timer's batch: 62,500 rows of 6 valid slots (a
    # lane a row) and the timer's long row; and a shard whose timers each
    # batched AGG_TIMER_BATCH values (their rows a warp each). Bytes counted
    # for this data: every valid flag, and the values (and time orders) of
    # valid slots only
    wide = {}
    shards = [(str(b), f"one timer batched {b} values", b, lambda b=b: wide_shard(b))
              for b in AGG_WIDE_P]
    shards.append((f"timers_{AGG_TIMER_BATCH}", f"every timer batched {AGG_TIMER_BATCH} values",
                   AGG_TIMER_BATCH, lambda: timer_shard(AGG_TIMER_BATCH)))
    for key_w, label, batch, make in shards:
        v, t, ok = (torch.from_numpy(a).to(dev) for a in make())
        g, p = v.shape
        if p != batch:
            raise AssertionError(f"a timer batching {batch} values widened its shard to {p}")
        n_valid = int(ok.sum())
        if not same_bits(K.aggregate_dense_fields(v, t, ok), K.aggregate_dense_reference(v, t, ok)):
            raise AssertionError(f"B-5a differs from its twin on the [{g}, {p}] wide shard")
        if not same_bits(K.dense_quantiles(v, ok, AGG_QS),
                         K.dense_quantiles_reference(v, ok, AGG_QS)):
            raise AssertionError(f"B-5b differs from its twin on the [{g}, {p}] wide shard")
        qt = torch.tensor(AGG_QS, dtype=torch.float32, device=dev)
        a_bytes = g * p + n_valid * 8 + len(K.FIELDS) * g * 4
        q_bytes = g * p + n_valid * 4 + len(AGG_QS) * g * 4
        wide[key_w] = {
            "shape": [g, p],
            "aggregate_dense": rollup_times(lambda: K.launch_aggregate_dense(v, t, ok),
                                            lambda: K.aggregate_dense_reference(v, t, ok),
                                            a_bytes / HBM_BYTES_PER_S * 1e3),
            "dense_quantiles": rollup_times(
                lambda: K.launch_dense_quantiles(v, ok, AGG_QS),
                lambda: K.dense_quantiles_reference(v, ok, AGG_QS),
                q_bytes / HBM_BYTES_PER_S * 1e3,
                lambda: torch.nanquantile(v, qt, dim=1, interpolation="linear")),
        }
        a, q = wide[key_w]["aggregate_dense"], wide[key_w]["dense_quantiles"]
        log(f"[aggregator] wide shard [{g:,}, {p}] ({label}, the rest 6): B-5a {a['ms']:.4f} ms "
            f"[{a['b2b']:.4f}], bound {a['bound_ms']:.4f} ms ({a_bytes / 1e6:.1f} MB, {a['share']:.1%}), twin "
            f"{a['plain_ms']:.3f} ms; B-5b p50/p95/p99 {q['ms']:.4f} ms "
            f"[{q['b2b']:.4f}], bound {q['bound_ms']:.4f} ms ({q_bytes / 1e6:.1f} MB, "
            f"{q['share']:.1%}), twin {q['plain_ms']:.3f} ms, torch.nanquantile "
            f"{q['library_ms']:.3f} ms; launch floor {floor_ms:.4f} ms; both == twin bit for bit")
        if parent_b5 is not None:
            for name, qs in (("aggregate_dense", None), ("dense_quantiles", AGG_QS)):
                key = f"{name} wide [{g:,}, {p}]"
                turns[key] = b5_turns(parent_b5, v, t, ok, qs)
                log(f"[aggregator] {key} in turns: {fmt_turns(turns[key])}")
        del v, t, ok
    torch.cuda.empty_cache()

    # 2. the Aggregator end to end, config 4 cut to a tenth
    n = AGG_E2E_SERIES
    pol = (StoragePolicy.parse("1m:40d"),)
    mids = [b"m3agg.series.%d" % i for i in range(n)]
    kinds = [MetricType.TIMER if i % 10 == 0 else MetricType.COUNTER if i % 2 else
             MetricType.GAUGE for i in range(n)]
    _, times, values = config4_points(n)
    rep = lambda xs: [x for x in xs for _ in range(AGG_POINTS)]
    rows = list(zip(rep(mids), rep(kinds), times.tolist(), values.tolist(),
                    itertools.repeat(pol), itertools.repeat(None)))
    agg = Aggregator(num_shards=16, default_policies=pol, device=dev)
    # one timer batching AGG_WIDE_P[k] values in shard k: those shards' rows
    # are that wide (a warp a row, the timer's row a long row), the other
    # 13 shards' rows 6 wide (a thread a row)
    batched = {}
    for k in itertools.count():
        mid = b"m3agg.batch.%d" % k
        shard = agg.shard_for(mid)
        if shard < len(AGG_WIDE_P):
            batched.setdefault(shard, mid)
        if len(batched) == len(AGG_WIDE_P):
            break
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    agg.add_timed_batch(rows)
    for shard, mid in sorted(batched.items()):
        agg.add_untimed(Untimed(type=MetricType.TIMER, id=mid, batch_timer_values=rng.lognormal(
            0, 1, AGG_WIDE_P[shard]).tolist()), AGG_T0 + 30 * 10**9)
    ingest_s = time.perf_counter() - t0
    del rows
    cpu = Aggregator(num_shards=16, default_policies=pol, device="cpu")
    cpu.shards = copy.deepcopy(agg.shards)  # the same buffered state
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    # B-5b's widths in this flush, read where its wrapper launches it
    widths = []
    launch = K.launch_dense_quantiles

    def launch_and_note(vals, valid, qs):
        widths.append(vals.shape[1])
        return launch(vals, valid, qs)

    K.launch_dense_quantiles = launch_and_note
    t0 = time.perf_counter()
    try:
        out = agg.flush(AGG_T0 + 2 * minute)
    finally:
        K.launch_dense_quantiles = launch
    flush_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if launches != {"aggregate_dense": 16, "dense_quantiles": 16}:
        raise AssertionError(f"the flush launched {launches}, want 16 of each (one a shard)")
    if sorted(w for w in widths if w > 32) != sorted(AGG_WIDE_P):
        raise AssertionError(f"B-5b's widths in the flush {widths}: want {AGG_WIDE_P} past 32")
    want = cpu.flush(AGG_T0 + 2 * minute)
    flat = lambda ms: [(m.id, m.time_nanos, int(m.agg_type), str(m.policy), m.value) for m in ms]
    n_out = 2 * n + 11 * len(AGG_WIDE_P)
    if len(out) != n_out or flat(out) != flat(want):
        raise AssertionError(f"the flush on the card ({len(out)} metrics) differs from the CPU's "
                             f"({len(want)}); want {n_out}")
    st = agg.stage_seconds
    log(f"[aggregator] Aggregator end to end, {n:,} series (config 4 cut to a tenth: the "
        f"ingest is a per-row host loop), 90% counters and gauges, 10% timers (11 default "
        f"aggregations), 1m:40d, plus {len(AGG_WIDE_P)} timers batching {AGG_WIDE_P} values "
        f"(untimed): {len(out):,} metrics == the CPU Aggregator's exactly; launches "
        f"{launches}; B-5b widths {sorted(widths)}")
    log(f"[aggregator] host seconds: ingest (add_timed_batch, {n * AGG_POINTS:,} rows) "
        f"{ingest_s:.3f}, flush {flush_s:.3f} of it densify {st['densify']:.3f}, device "
        f"(upload + B-5a + B-5b) {st['device']:.3f}, readback {st['readback']:.3f}, emit "
        f"{st['emit']:.3f}; the CPU flush {sum(cpu.stage_seconds.values()):.3f}")
    del agg, cpu, out, want

    # 3. the Downsampler: a mapping rule, a rollup rule with a per_second
    # pipeline, two flushes (the pipeline's carry spans them)
    p10 = StoragePolicy.parse("10s:2d")
    rs = RuleSet(
        mapping_rules=[MappingRule("map", TagsFilter.parse("service:auth"), policies=(p10,))],
        rollup_rules=[RollupRule("rollup", TagsFilter.parse("service:auth"), targets=(
            RollupTarget(new_name=b"auth.total", group_by=(b"dc",),
                         aggregations=(AggregationType.SUM,), policies=(p10,),
                         pipeline=(TransformationType.PERSECOND,)),))])
    card = Downsampler(ruleset=rs, aggregator=Aggregator(num_shards=4, device=dev))
    host = Downsampler(ruleset=rs, aggregator=Aggregator(num_shards=4, device="cpu"))
    before = dict(K.LAUNCHES)
    flushed = []
    for w0, w1, up_to in ((0, 3, 40), (3, 5, 60)):
        batch = [(make_tags({"__name__": "req", "service": "auth", "dc": f"dc{h % 3}",
                             "host": f"h{h}"}), AGG_T0 + (w * 10 + 1) * 10**9,
                  float((w + 1) * (h + 1)), MetricType.COUNTER)
                 for w in range(w0, w1) for h in range(100)]
        card.write_batch(batch)
        host.write_batch(batch)
        got, want = card.flush(AGG_T0 + up_to * 10**9), host.flush(AGG_T0 + up_to * 10**9)
        if flat(got) != flat(want):
            raise AssertionError("the Downsampler on the card differs from the CPU's")
        flushed += [m for m in got if b"auth.total" in m.id]
    rates = sorted(m.value for m in flushed)
    if K.LAUNCHES["aggregate_dense"] == before["aggregate_dense"] or len(rates) != 12:
        raise AssertionError(f"the Downsampler's rollups: {len(rates)} rates, B-5a launches "
                             f"{K.LAUNCHES['aggregate_dense'] - before['aggregate_dense']}")
    log(f"[aggregator] Downsampler (mapping rule + per_second rollup by dc, 100 hosts, two "
        f"flushes) == the CPU's exactly; {len(rates)} rollup rates, B-5a launched "
        f"{K.LAUNCHES['aggregate_dense'] - before['aggregate_dense']} times")
    log(f"[aggregator] phase {time.perf_counter() - t_phase:.1f}s")
    main = b5b["all groups"]
    kernels += [{
        "name": "aggregate_dense",
        "route": "cuda",
        "source": "m3_tpu_torch/aggregator/csrc/rollup.cu",
        "replaces": "m3_tpu/aggregator/kernels.py:183",
        "launches": launches["aggregate_dense"],
        "max_abs_err": 0.0,
        "ms": b5a["ms"],
        "plain_ms": b5a["plain_ms"],
        "bound_ms": b5a["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": floor_ms,
        "wide_shard": {b: {"shape": w["shape"], **w["aggregate_dense"]}
                       for b, w in wide.items()},
        "parent_turns": {k: v for k, v in turns.items() if k.startswith("aggregate_dense")},
    }, {
        "name": "dense_quantiles",
        "route": "cuda",
        "source": "m3_tpu_torch/aggregator/csrc/rollup.cu",
        "replaces": "m3_tpu/aggregator/kernels.py:224",
        "launches": launches["dense_quantiles"],
        "max_abs_err": 0.0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
        "launch_floor_ms": floor_ms,
        "timer_slice": b5b["timer slice"],
        "wide_shard": {b: {"shape": w["shape"], **w["dense_quantiles"]}
                       for b, w in wide.items()},
        "parent_turns": {k: v for k, v in turns.items() if k.startswith("dense_quantiles")},
    }]


def ingest_lanes(m: int, n: int, seed: int):
    """The encode lanes of bench_suite.py:721-735 (its seal-kernel generator):
    times T0 + cumsum(integers(1, 30)) s, every dod opcode; odd lanes int
    values in [-5000, 5000), even lanes normal(0, 10); drawn from ``seed`` as
    whole [m, n] planes."""
    rng = np.random.default_rng(seed)
    t = T0 + np.cumsum(rng.integers(1, 30, (m, n)), axis=1) * 10**9
    ints = rng.integers(-5000, 5000, (m, n)).astype(np.float64)
    floats = rng.normal(0, 10, (m, n))
    return t, np.where((np.arange(m) % 2 == 1)[:, None], ints, floats)


def ingest_entries(n_series: int, n_points: int, b0: int, seed: int):
    """One write_batch of ``n_series`` x ``n_points`` at 10 s from ``b0``: a
    series in ten mixes int and float values (a host-fallback lane), the rest
    alternate a random walk of ints and normal(0, 10) floats; one series in
    fifty has two points swapped (an out-of-order write: a dirty lane).
    Returns (entries, the sorted points of each series)."""
    rng = np.random.default_rng(seed)
    t = b0 + np.arange(n_points, dtype=np.int64) * STEP
    entries, want = [], {}
    for i in range(n_series):
        sid = f"ingest-{i}".encode()
        if i % 10 == 0:
            v = np.where(np.arange(n_points) % 2 == 0, rng.normal(0, 5, n_points),
                         np.arange(n_points, dtype=np.float64))
        elif i % 2:
            v = np.cumsum(rng.integers(-50, 51, n_points)).astype(np.float64)
        else:
            v = rng.normal(0, 10, n_points)
        pts = list(zip(t.tolist(), v.tolist()))
        want[sid] = list(pts)
        if i % 50 == 1:
            pts[100], pts[101] = pts[101], pts[100]
        entries += [(sid, a, b) for a, b in pts]
    return entries, want


def phase_hostcodec() -> None:
    """The host codec library (m3_tpu_torch/native/) at BASELINE config 3's
    scale, each call timed with series/s, and on its first HOSTCODEC_CHECK
    series the port's pure-Python codec with the same calls: every output
    identical (stream bytes, snapshot fields, triples bit for bit, shard
    ids)."""
    from m3_tpu_torch import native
    from m3_tpu_torch.codec.m3tsz import decode, encode_series
    from m3_tpu_torch.ops.chunked import snapshot_stream
    from m3_tpu_torch.utils.hash import shard_for

    t_phase = time.perf_counter()
    m, n, c = INGEST_LANES, N_POINTS, HOSTCODEC_CHECK
    t, v = ingest_lanes(m, n, INGEST_SEED)
    ids = [f"m3_scan,host=h{i},job=job-{i % QUERY_JOBS}".encode() for i in range(m)]
    lib_s, py_s = {}, {}

    t0 = time.perf_counter()
    streams = native.encode_batch(t.reshape(-1), v.reshape(-1), np.full(m, n, np.int32))
    lib_s["encode_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_streams = [encode_series(t[i].tolist(), v[i].tolist()) for i in range(c)]
    py_s["encode_batch"] = time.perf_counter() - t0
    if streams[:c] != py_streams:
        bad = next(i for i in range(c) if streams[i] != py_streams[i])
        raise AssertionError(f"[hostcodec] encode_batch: series {bad}'s bytes differ from "
                             f"encode_series'")

    t0 = time.perf_counter()
    recs, counts = native.prescan_records(streams, k=K)
    lib_s["prescan_batch C++"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    snaps = native.snapshot_dicts(streams, recs, counts)
    lib_s["prescan_batch dicts"] = time.perf_counter() - t0
    n_snaps = int(counts.sum())
    del recs
    t0 = time.perf_counter()
    py_snaps = [snapshot_stream(x, K) for x in streams[:c]]
    py_s["prescan_batch"] = time.perf_counter() - t0
    if snaps[:c] != py_snaps or n_snaps != m * (-(-n // K)):
        raise AssertionError(f"[hostcodec] prescan_batch differs from snapshot_stream, or "
                             f"{n_snaps} snapshots for {m} series of {n} points at k={K}")
    del snaps

    t0 = time.perf_counter()
    triples = native.decode_batch(streams, max_points=n)
    lib_s["decode_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_triples = [decode(x) for x in streams[:c]]
    py_s["decode_batch"] = time.perf_counter() - t0
    for i, (tt, vv, uu) in enumerate(triples):
        if not np.array_equal(tt, t[i]) or (i % 2 and not np.array_equal(vv, v[i])):
            raise AssertionError(f"[hostcodec] decode_batch: series {i} does not read back")
    for i, dps in enumerate(py_triples):
        want = (np.asarray([d.timestamp for d in dps], np.int64),
                np.asarray([d.value for d in dps], np.float64),
                np.asarray([int(d.unit) for d in dps], np.uint8))
        if not all(a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
                   for a, b in zip(triples[i], want)):
            raise AssertionError(f"[hostcodec] decode_batch: series {i}'s triple differs from "
                                 f"decode's")
    del triples, py_triples

    t0 = time.perf_counter()
    shards = native.shard_batch(ids, DB_SHARDS)
    lib_s["shard_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_shards = [shard_for(x, DB_SHARDS) for x in ids[:c]]
    py_s["shard_batch"] = time.perf_counter() - t0
    if shards[:c].tolist() != py_shards or not 0 <= shards.min() <= shards.max() < DB_SHARDS:
        raise AssertionError("[hostcodec] shard_batch differs from utils/hash.shard_for")

    nbytes = sum(len(x) for x in streams)
    log(f"[hostcodec] {m:,} series x {n} points (ingest generator, seed {INGEST_SEED}), "
        f"{nbytes:,} stream bytes, {n_snaps:,} snapshots at k={K}; the first {c} series == "
        f"the Python codec's (bytes, snapshot fields, triples bit for bit, shard ids into "
        f"{DB_SHARDS}); every series decodes to its input times (int lanes' values too)")
    for name, sec in lib_s.items():
        log(f"[hostcodec] library {name}: {sec:.3f} s, {m / sec:,.0f} series/s")
    for name, sec in py_s.items():
        log(f"[hostcodec] Python {name} ({c} series): {sec:.3f} s, {c / sec:,.0f} series/s")
    log(f"[hostcodec] phase {time.perf_counter() - t_phase:.1f}s")


def phase_ingest(dev, kernels: list, parent_b4=None) -> None:
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from m3_tpu_torch.cache.block_cache import BlockKey
    from m3_tpu_torch.codec.m3tsz import encode_series
    from m3_tpu_torch.index.device import kernels as IK
    from m3_tpu_torch.ingest import IngestOptions
    from m3_tpu_torch.ops import encode as E
    from m3_tpu_torch.ops._build import load_library
    from m3_tpu_torch.resident import ResidentOptions
    from m3_tpu_torch.storage.database import SEAL_STAGES, Database, NamespaceOptions

    t_phase = time.perf_counter()
    m, n = INGEST_LANES, N_POINTS
    # 1. B-4 at a real seal's size: BASELINE config 3's node seals 100,000
    # series x 720 points (the 2 h block at 10 s)
    t0 = time.perf_counter()
    t, v = ingest_lanes(m, n, INGEST_SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kinds = E.classify_lanes(t.reshape(-1), v.reshape(-1), np.ones(m * n, np.int8), np.full(m, n))
    classify_s = time.perf_counter() - t0
    if not np.array_equal(kinds, np.where(np.arange(m) % 2 == 1, E.KIND_INT, E.KIND_FLOAT)):
        raise AssertionError("[ingest] a generated lane did not classify as its kind")
    lanes = [(t[i], v[i]) for i in range(m)]
    t0 = time.perf_counter()
    host = E.pack_lanes(lanes, kinds)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inp = E.upload_lanes(host, 32, 512, dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del host
    T, _ = inp.dod.shape
    C = (T + inp.k - 1) // inp.k
    got = E.launch_encode(inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = E.encode_reference(inp)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    for name, a, b in zip(("words", "total_bits", "chunk_offs", "chunk_sigs"), got, want):
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist()
            raise AssertionError(f"[ingest] B-4 {name} differs from its twin at {bad}")
    del want
    res = E.result_of(inp, got, kinds)
    head = E.EncodeResult(res.words[:256], *res[1:])
    for i, stream in enumerate(head.streams()):
        if stream != encode_series(t[i].tolist(), v[i].tolist()):
            raise AssertionError(f"[ingest] lane {i}'s stream differs from the host codec's")
    # every word of the rows is the kernel's: into outputs filled with -1 it
    # gives the same (its C entry, not a main-path launch)
    poisoned = b4_outputs(inp, -1)
    b4_call(load_library("encode").m3_encode_lanes, inp, poisoned)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, poisoned)):
        raise AssertionError("[ingest] B-4 left words of its outputs unwritten")
    del poisoned
    ms = cuda_ms(lambda: E.launch_encode(inp), 10)
    b2b = per_launch_ms(lambda: E.launch_encode(inp), 10)
    floor_ms = statistics.median(cuda_ms(lambda: IK.launch_floor(dev), 20))
    in_bytes = m * n * (4 + 8) + m * (8 + 4 + 1)  # the records read, each lane's t0/count/kind
    word_bytes = m * inp.words * 4
    out_bytes = word_bytes + 2 * C * m * 4 + m * 4
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    b4_ms = statistics.median(ms)
    shape = E.launch_shape(m)
    turns = b4_turns(parent_b4, inp) if parent_b4 is not None else None
    log(f"[ingest] B-4 [{m:,} lanes x {n} points] (T_pad {T}, W {inp.words} words, k {inp.k}) "
        f"== twin bit for bit on words, total_bits, chunk_offs and chunk_sigs; the first 256 "
        f"lanes' streams == encode_series; {int(res.nbytes.sum()):,} stream bytes "
        f"({res.nbytes.sum() / (m * n):.3f} B a point)")
    log(f"[ingest] B-4 {b4_ms:.3f} ms [{b2b:.3f}] (CUDA events, median of 10 [back to back]), "
        f"bound {bound_ms:.3f} ms (bytes: {in_bytes / 1e9:.3f} GB of records read + "
        f"{out_bytes / 1e9:.3f} GB written, {word_bytes / 1e9:.3f} GB of it the [M, W] rows, "
        f"zeros included; {bound_ms / b4_ms:.1%}), launch floor {floor_ms:.4f} ms, twin on the "
        f"card {twin_ms:.1f} ms")
    log(f"[ingest] B-4 launch: {shape['warps']} warps a block (a lane a warp), "
        f"{shape['blocks']:,} blocks ({shape['resident_blocks']:,} resident at once), "
        f"{shape['smem_bytes']:,} B of shared memory a block, {shape['registers']} registers and "
        f"{shape['local_bytes']} B of local memory a thread; ptxas: "
        f"{ptxas_report('encode', 'encode_kernel')}")
    if turns is not None:
        log(f"[ingest] B-4 in turns with the parent's (C entries, outputs equal bit for bit, "
            f"ms single [back to back]): {fmt_turns(turns)}; bound {bound_ms:.3f} ms, launch "
            f"floor {floor_ms:.4f} ms")
    log(f"[ingest] host seconds: generate {gen_s:.2f}, classify_lanes {classify_s:.2f}, "
        f"pack_lanes {pack_s:.2f}, upload_lanes (copies + transposes on the card) {upload_s:.2f}; "
        f"input planes {(inp.dod.nbytes + inp.vbits.nbytes) / 1e9:.3f} GB on the card")
    del got, res, head, inp, lanes, t, v
    torch.cuda.empty_cache()

    # 2. the write path end to end: two storage nodes, the same write_batch
    b0 = T0 // BLOCK * BLOCK
    entries, want = ingest_entries(INGEST_E2E_SERIES, n, b0, INGEST_SEED + 1)
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    base = tempfile.mkdtemp(prefix="chip_smoke_ingest-", dir=root)
    try:
        nodes, files = {}, {}
        for name, ingest in (("host", None), ("device", IngestOptions())):
            db = Database(str(Path(base) / name), num_shards=DB_SHARDS,
                          resident_options=ResidentOptions(max_bytes=1 << 30),
                          ingest_options=ingest, device=dev)
            db.create_namespace("m3", NamespaceOptions())
            db.bootstrap()
            E.LAUNCHES["encode"] = 0
            t0 = time.perf_counter()
            db.write_batch("m3", entries)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            flushed = db.flush("m3", b0 + BLOCK)
            torch.cuda.synchronize()
            flush_s = time.perf_counter() - t0
            launches = E.LAUNCHES["encode"]
            shards = db.namespaces["m3"].shards
            stages = {k: sum(sh.seal_seconds[k] for sh in shards) for k in SEAL_STAGES}
            nodes[name] = (db, write_s, flush_s, launches, stages, len(flushed))
            files[name] = {}
            data = Path(base) / name / "data"
            for path in sorted(data.rglob("*")):
                if path.is_file():
                    files[name][str(path.relative_to(data))] = path.read_bytes()
        if not files["host"] or files["device"] != files["host"]:
            raise AssertionError("[ingest] the two nodes' fileset files differ")
        dev_db, host_db = nodes["device"][0], nodes["host"][0]
        t0 = time.perf_counter()
        for sid, pts in want.items():
            pts = sorted(pts)
            a = [(d.timestamp, d.value) for d in dev_db.read("m3", sid, b0, b0 + BLOCK)]
            b = [(d.timestamp, d.value) for d in host_db.read("m3", sid, b0, b0 + BLOCK)]
            if a != b or a != pts:
                raise AssertionError(f"[ingest] {sid!r} reads back differently")
        read_s = time.perf_counter() - t0
        eligible = sum(1 for i in range(INGEST_E2E_SERIES) if i % 10)
        sd, sh = dev_db.resident_stats(), host_db.resident_stats()
        pool, ns = dev_db.resident_pool, dev_db.namespaces["m3"]
        fallback_bytes = sum(
            len(pool.get(BlockKey("m3", ns.shard_for(sid).id, sid, b0, 0)).pages)
            * pool.options.page_bytes for sid in list(want)[::10])
        ing = [s.ingest.stats() for s in dev_db.namespaces["m3"].shards]
        spilled = sum(sum(st["spills"].values()) for st in ing)
        dirty = sum(st["dirty_lane_fallbacks"] for st in ing)
        launches = nodes["device"][3]
        if (sd["device_admissions"] != eligible or sd["admissions"] != sh["admissions"]
                or sd["admissions"] != INGEST_E2E_SERIES or sh["device_admissions"] != 0
                or sd["upload_bytes"] != fallback_bytes or not 0 < sd["upload_bytes"] < sh["upload_bytes"]
                or spilled or launches == 0 or nodes["host"][3] != 0
                or dirty != INGEST_E2E_SERIES // 50):
            raise AssertionError(f"[ingest] device node {sd}, host node {sh}, spills {spilled}, "
                                 f"dirty {dirty}, B-4 launches {launches}")
        for name in ("host", "device"):
            _db, write_s, flush_s, n_launch, stages, n_fs = nodes[name]
            log(f"[ingest] {name} node ({DB_SHARDS} shards, residency on, commit log on"
                f"{', device ingest' if name == 'device' else ''}): write_batch of "
                f"{INGEST_E2E_SERIES:,} series x {n} points {write_s:.2f} s; flush {flush_s:.2f} s "
                f"({n_fs} filesets, B-4 launches {n_launch}); seal seconds by stage: "
                + ", ".join(f"{k} {stages[k]:.3f}" for k in SEAL_STAGES))
        log(f"[ingest] filesets byte-identical ({len(files['host'])} files), every series reads "
            f"back equal on both nodes ({read_s:.1f} s); device node: {sd['device_admissions']} "
            f"lanes born resident of {sd['admissions']} admitted, upload {sd['upload_bytes']:,} B "
            f"(the {INGEST_E2E_SERIES - eligible} fallback lanes' pages) vs the host node's "
            f"{sh['upload_bytes']:,} B, side rows staged {sd['ingest_side_stage_bytes']:,} B; "
            f"ingest spills {spilled}, dirty lanes {dirty}, syncs "
            f"{sum(st['device_syncs'] for st in ing)} ({sum(st['device_sync_bytes'] for st in ing):,} B)")
        for db, *_ in nodes.values():
            db.close()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"[ingest] phase {time.perf_counter() - t_phase:.1f}s")
    kernels.append({
        "name": "encode",
        "route": "cuda",
        "source": "m3_tpu_torch/ops/csrc/encode.cu",
        "replaces": "m3_tpu/ops/encode.py:153",
        "launches": launches,
        "max_abs_err": 0.0,
        "ms": b4_ms,
        "plain_ms": twin_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": floor_ms,
        "back_to_back_ms": b2b,
        "launch_shape": shape,
        **({"parent_turns": turns} if turns is not None else {}),
    })


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED, help="seed of the [index] phase's tags")
    ap.add_argument("--parent-b1", metavar="CU", default=None,
                    help="another tree's query/csrc/consolidate_grid.cu (a parent commit "
                         "unpacked beside this checkout): [query] times its B-1 in turns with "
                         "this one's")
    ap.add_argument("--parent-b5", metavar="CU", default=None,
                    help="another tree's aggregator/csrc/rollup.cu (a parent commit unpacked "
                         "beside this checkout): [aggregator] times its B-5a and B-5b in turns "
                         "with this one's")
    ap.add_argument("--parent-b4", metavar="CU", default=None,
                    help="another tree's ops/csrc/encode.cu (a parent commit unpacked beside "
                         "this checkout): [ingest] times its B-4 in turns with this one's")
    ap.add_argument("--parent-b6", metavar="CU", default=None,
                    help="another tree's ops/csrc/lane_aggregates.cu (a parent commit unpacked "
                         "beside this checkout): [batched] times its B-6 in turns with this one's")
    ap.add_argument("--parent-b7", metavar="CU", default=None,
                    help="another tree's query/functions/csrc/temporal_window.cu (a parent "
                         "commit unpacked beside this checkout): [promql] times its B-7 in "
                         "turns with this one's")
    ap.add_argument("--parent-scan", metavar="PY", default=None,
                    help="another tree's m3_tpu_torch/parallel/scan.py (a parent commit "
                         "unpacked beside this checkout): [main] times its scan's reductions "
                         "in turns with this one's")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    from m3_tpu_torch.ops import _build

    dev = DEVICE
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    parent_build = build_parent(args.parent_b1, "consolidate_grid") if args.parent_b1 else None
    parent_b7_build = build_parent(args.parent_b7, "temporal_window") if args.parent_b7 else None
    parent_b5_build = build_parent(args.parent_b5, "rollup") if args.parent_b5 else None
    parent_b4_build = build_parent(args.parent_b4, "encode") if args.parent_b4 else None
    parent_b6_build = (build_parent(args.parent_b6, "lane_aggregates") if args.parent_b6
                       else None)
    _build.build_all()
    parent_b1 = load_parent_b1(*parent_build) if parent_build else None
    parent_b7 = load_parent_b7(*parent_b7_build) if parent_b7_build else None
    parent_b5 = load_parent_b5(*parent_b5_build) if parent_b5_build else None
    parent_b4 = load_parent_b4(*parent_b4_build) if parent_b4_build else None
    parent_b6 = load_parent_b6(*parent_b6_build) if parent_b6_build else None
    log(f"[build] {', '.join([*_build.SOURCES, *_build.HOST_SOURCES])} built in parallel in "
        f"{time.perf_counter() - t0:.2f}s")
    for lib, text in _build.BUILD_LOG.items():
        log(f"[build] {lib}:\n{text.strip()}")

    worst = phase_parity(dev)
    b3_worst = phase_parity_fields(dev)
    parent_scan = load_parent_scan(args.parent_scan) if args.parent_scan else None
    main_e2e_s, b1 = phase_main(dev, worst, parent_scan)
    kernels = [b1]
    mesh, mesh_dir = open_mesh()
    b2 = phase_resident(dev, kernels, b3_worst, main_e2e_s, mesh)
    single = phase_batched(dev, kernels, main_e2e_s, b1["ms"], parent_b6)
    phase_mesh(dev, mesh, single)
    del single
    close_mesh(mesh_dir)
    phase_stream(dev)
    phase_records(dev)
    temporal_err = phase_temporal(dev)
    temporal_err = max(temporal_err, phase_temporal_sizes(dev))
    b1, storage = phase_query(dev, kernels, temporal_err, parent_b1)
    phase_promql(dev, kernels, storage, parent_b7)
    del storage
    phase_index(dev, kernels, args.seed)
    phase_hostcodec()
    phase_database(dev, kernels, b2, b1)
    phase_ingest(dev, kernels, parent_b4)
    phase_aggregator(dev, kernels, parent_b5)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
