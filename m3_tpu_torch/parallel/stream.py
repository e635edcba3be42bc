"""Host-to-device streaming: pinned uploads overlapped with the lane kernel.

Port of ``m3_tpu/parallel/stream.py``. Where the working set exceeds device
memory, a scan streams: batches of packed lanes (``fused.pack_lanes`` on the
host, the bytes filesets hold) go up one after the other, each decoded by
kernel B1 (``chunked_scan_aggregate_packed``) and folded into running
totals on the device. At most ``prefetch`` batches are in flight; the oldest
is drained by an 8-byte read of its total count, which bounds the device
memory the stream holds.

On the card each batch is copied into pinned host memory and uploaded with
``non_blocking`` copies on a side stream; the kernel's stream waits on an
event recorded after the copies, so the upload of batch N + 1 overlaps the
decode of batch N. (The reference waits for each upload to finish before it
dispatches, a workaround for a tunnelled transport; the totals do not
depend on it.)
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import resolve_device
from ..ops import fused
from .scan import chunked_scan_aggregate_packed


class StreamTotals:
    """Cross-batch totals of the per-batch ScanAggregates, folded on the
    device (no host read a batch); ``finalize()`` reads them back once. The
    count is int64 (the reference carries a (hi, lo) pair: it has no x64)."""

    def __init__(self) -> None:
        self._acc = None  # (sum f32, count i64, min f32, max f32) on the device
        self._final = None  # host snapshot for the properties
        self.batches = 0

    def fold(self, agg) -> None:
        has = agg.total_count > 0
        if self._acc is None:
            dev = agg.total_sum.device
            f32 = dict(dtype=torch.float32, device=dev)
            self._acc = (torch.zeros((), **f32), torch.zeros((), dtype=torch.int64, device=dev),
                         torch.full((), torch.inf, **f32), torch.full((), -torch.inf, **f32))
        a_sum, a_cnt, a_min, a_max = self._acc
        self._acc = (
            a_sum + torch.where(has, agg.total_sum, 0.0),
            a_cnt + agg.total_count,
            torch.minimum(a_min, torch.where(has, agg.total_min, torch.inf)),
            torch.maximum(a_max, torch.where(has, agg.total_max, -torch.inf)),
        )
        self._final = None  # a snapshot taken mid-stream is stale now
        self.batches += 1

    def finalize(self) -> tuple:
        """(sum, count, min, max) as Python numbers, by one device-to-host
        copy; safe mid-stream (the device accumulator is left as it is, so
        later folds keep working)."""
        if self._final is None:
            if self._acc is None:
                self._final = (0.0, 0, float("inf"), float("-inf"))
            else:
                a_sum, a_cnt, a_min, a_max = self._acc
                bits = lambda x: x.view(torch.int32).to(torch.int64)
                host = torch.stack([bits(a_sum), a_cnt, bits(a_min), bits(a_max)]).cpu().numpy()
                f = host[[0, 2, 3]].astype(np.int32).view(np.float32)
                self._final = (float(f[0]), int(host[1]), float(f[1]), float(f[2]))
        return self._final

    @property
    def total_sum(self) -> float:
        return self.finalize()[0]

    @property
    def total_count(self) -> int:
        return self.finalize()[1]

    @property
    def total_min(self) -> float:
        return self.finalize()[2]

    @property
    def total_max(self) -> float:
        return self.finalize()[3]


def packed_batches(batches: Iterable) -> Iterator[tuple]:
    """ChunkedBatch iterable -> (PackedLanes on the CPU, s, c, k) host
    batches, chunk-major lanes packed on the host (``fused.pack_lanes``)."""
    for batch in batches:
        yield (fused.pack_lanes(batch, device="cpu"), batch.num_series, batch.num_chunks,
               batch.k)


def stream_aggregate(host_batches: Iterable[tuple], prefetch: int = 2,
                     drain_times: list | None = None, device="cuda") -> StreamTotals:
    """Stream ``packed_batches``' host batches through kernel B1 on
    ``device`` with up to ``prefetch`` batches in flight, and fold their
    totals. ``drain_times`` (optional list) receives a perf_counter stamp a
    drained batch, for the steady-state interval."""
    dev = resolve_device(device)
    totals = StreamTotals()
    inflight: deque = deque()
    upload = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def drain_one():
        agg, _ = inflight.popleft()
        totals.fold(agg)
        # an 8-byte read ordered after the batch's kernel: it bounds the
        # batches in flight for real (the pinned buffers it holds go with it)
        agg.total_count.item()
        if drain_times is not None:
            drain_times.append(time.perf_counter())

    for packed, s, c, k in host_batches:
        host = (packed.windows, packed.lanes, packed.tile_flags)
        if upload is None:
            on_dev = tuple(x.to(dev) for x in host)
        else:
            host = tuple(x.pin_memory() for x in host)
            compute = torch.cuda.current_stream(dev)
            with torch.cuda.stream(upload):
                on_dev = tuple(x.to(dev, non_blocking=True) for x in host)
                ready = torch.cuda.Event()
                ready.record(upload)
            compute.wait_event(ready)
            for x in on_dev:  # allocated on the side stream, used on the kernel's
                x.record_stream(compute)
        lanes = packed._replace(windows=on_dev[0], lanes=on_dev[1], tile_flags=on_dev[2])
        inflight.append((chunked_scan_aggregate_packed(lanes, s=s, c=c, k=k), host))
        if len(inflight) > prefetch:
            drain_one()
    while inflight:
        drain_one()
    return totals


def fileset_packed_batches(readers: Iterable, batch_series: int = 65536):
    """FilesetReader iterable -> packed host batches straight off the side
    tables (no host prescan): the production fetch -> upload path."""
    for reader in readers:
        sids = reader.series_ids
        for i in range(0, len(sids), batch_series):
            chunk = reader.chunked_batch(sids[i : i + batch_series])
            yield from packed_batches([chunk])
