"""Decode-from-residency scans over the resident pool.

Port of ``m3_tpu/resident/scan.py``. ``plan_chunked`` hands over O(series)
int vectors; the lane assembly (``parallel/scan.assemble_resident_*``)
gathers the lanes on the device from the pool's pages and side planes, and
the same kernels the streamed path launches decode them: B1 for scans, R
for exact datapoint fetches.

Bit-exactness: ``resident_scan_totals`` and ``streamed_scan_totals`` run
one decode + reduction path (``chunked_scan_aggregate_packed``) over packed
lanes that are bit-identical, padded to the same series count, so their
f32 results match bit for bit.
"""

from __future__ import annotations

import torch

from ..ops import fused
from ..utils.instrument import DEFAULT as METRICS
from .pool import CHUNK_K

# host->device block bytes moved by the streamed scan; warm resident scans
# leave this and resident_upload_bytes_total untouched
_M_STREAMED_BYTES = METRICS.counter(
    "scan_streamed_bytes_total",
    "host->device block bytes uploaded by the streamed scan fallback",
)

_MIN_LANES = 8


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << max(int(n) - 1, 0).bit_length())


def resident_scan_totals(pool, keys: list, mesh=None, device_out: bool = False):
    """Scan-and-aggregate the resident lanes of ``keys`` (one per (series,
    block) key) with kernel B1 over the device-assembled packed lanes.
    Returns ScanAggregates with the per-series arrays sliced to
    ``len(keys)`` and copied to the host, or None when a key is not
    resident or has no side planes (the caller streams instead).
    ``device_out``: return the padded aggregates on the device instead.

    ``mesh`` (a ``parallel/mesh.SeriesMesh``): every rank holds the same
    pool and keys; each scans its slice of the padded series
    (``parallel/scan.make_sharded_resident_chunked_scan``), the totals are
    all-reduced and the per-series arrays gathered, so every rank returns
    the whole result. The series pad to the reference's power of two of at
    least the mesh size, rounded up to a multiple of a size that does not
    divide it (the reference's shard_map refuses such a mesh)."""
    from ..parallel.scan import (RESIDENT_CHUNKED_PROF, make_sharded_resident_chunked_scan,
                                 pad_chunked_plan)

    with pool.read_lease():
        plan = pool.plan_chunked(keys)
        if plan is None:
            return None
        s = len(keys)
        s_pad = _pow2(s, _MIN_LANES)
        if mesh is not None:
            s_pad = _pow2(max(s_pad, mesh.size), _MIN_LANES)
            s_pad = -(-s_pad // mesh.size) * mesh.size
        shape_key = (plan.num_chunks, plan.chunk_k, plan.window_words,
                     plan.page_words, plan.side_page_chunks)
        # the assembly (B-2) and the lane kernel (B1) as ONE dispatch, the
        # reference's one jitted program
        with RESIDENT_CHUNKED_PROF.dispatch(("scan", s_pad, *shape_key, mesh is not None)) as d:
            fn = make_sharded_resident_chunked_scan(mesh, *shape_key)
            aggs = fn(plan.words, plan.side, *pad_chunked_plan(plan, s_pad))
            aggs = d.done(aggs if mesh is None else _gather_series(mesh, aggs))
    return aggs if device_out else _slice_series(aggs, s)


def streamed_scan_totals(segments: list, k: int = CHUNK_K, device="cuda"):
    """The streamed twin of ``resident_scan_totals``: prescan and upload
    ``segments`` (one M3TSZ stream per lane) as packed lanes and run the
    same decode and reductions with the same series padding. Charges the
    compressed block bytes to ``scan_streamed_bytes_total``. ``k`` must be
    the chunk size the resident lanes were admitted with: the chunking sets
    the f32 reduction order."""
    from ..ops.chunked import build_chunked
    from ..parallel.scan import chunked_scan_aggregate_packed

    s = len(segments)
    s_pad = _pow2(s, _MIN_LANES)
    batch = build_chunked(list(segments) + [b""] * (s_pad - s), k=k)
    packed = fused.pack_lanes(batch, device=device)
    _M_STREAMED_BYTES.inc(sum(len(seg) for seg in segments))
    aggs = chunked_scan_aggregate_packed(packed, s=s_pad, c=batch.num_chunks, k=k)
    return _slice_series(aggs, s)


_SERIES_FIELDS = (
    "series_sum", "series_count", "series_min", "series_max", "series_last", "series_err",
)


def _gather_series(mesh, aggs):
    """A rank's sharded aggregates with every rank's per-series arrays
    gathered in rank order (the totals are already the mesh's)."""
    out = {name: mesh.all_gather(getattr(aggs, name)) for name in _SERIES_FIELDS[:-1]}
    out["series_err"] = mesh.all_gather(aggs.series_err.to(torch.uint8)).to(torch.bool)
    return aggs._replace(**out)


def _slice_series(aggs, s: int):
    """The per-series arrays cut to the first ``s`` series, on the host."""
    return aggs._replace(**{
        name: getattr(aggs, name)[:s].cpu() for name in _SERIES_FIELDS
        if getattr(aggs, name) is not None
    })


def resident_fetch_arrays(pool, keys: list):
    """Exact datapoints from residency: kernel R decodes the resident lanes
    of ``keys`` (series-major packed lanes from the same device gather) and
    ``finalize_decode`` gives their f64 values. Returns ``([(times i64[n],
    values f64[n])], err bool[S])`` as numpy, bit-exact vs the host codec;
    ``err[i]`` flags lanes the device decode bailed on (annotated streams),
    for the caller to re-read on the host. None when a key is not resident."""
    from ..ops.chunked import decode_chunked
    from ..ops.decode import finalize_decode
    from ..parallel.scan import RESIDENT_CHUNKED_PROF, assemble_resident_packed

    with pool.read_lease():
        plan = pool.plan_chunked(keys)
        if plan is None:
            return None
        s = len(keys)
        packed, s_pad = assemble_resident_packed(plan, _pow2(s, _MIN_LANES), order="s")
        with RESIDENT_CHUNKED_PROF.dispatch(
            ("fetch", tuple(packed.windows.shape), int(plan.chunk_k))
        ) as d:
            res = d.done(decode_chunked(packed.windows, packed.lanes, s_pad, plan.num_chunks,
                                        plan.chunk_k))
    timestamps, values, valid = (x[:s].cpu().numpy() for x in finalize_decode(res))
    err = res.err[:s].cpu().numpy()
    return [(timestamps[i][valid[i]], values[i][valid[i]]) for i in range(s)], err
