"""The host codec library: ctypes bindings of ``native/m3tsz.cc``.

Port of ``m3_tpu/native/__init__.py``, with its names, signatures and
return shapes. The library is the package's own copy of the JAX package's
C++ codec (batch M3TSZ encode, side-table prescan, batch decode, the
aggregator's window densify, murmur3 shard routing), built by g++ into
``build/kernels/`` at first use (``ops/_build.HOST_SOURCES``), on the CPU
too. There is no pure-Python fallback: a failed build raises at the first
call. The pure-Python codec (``codec/m3tsz.py``,
``ops/chunked.snapshot_stream``) stays as the library's plain version,
which the tests hold it to.

Every host path where the reference calls its library calls this one:
``ops/chunked.build_chunked``, the fileset write (``storage/fs.py``), the
series buffer's encode (``storage/series.py``), the Database's write and
bootstrap routing, ``ResidentPool._prescan``, ``codec/native_read.py`` and
``utils/synthetic.py``. Calls release the interpreter lock while the
library runs (ctypes), with ``min(os.cpu_count(), 16)`` threads a batch
call unless ``n_threads`` says otherwise.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..ops import _build


class _SnapRec(ctypes.Structure):
    """One chunk snapshot as the library writes it (``SnapRec`` in
    m3tsz.cc, packed: 49 bytes)."""

    _pack_ = 1
    _fields_ = [
        ("off", ctypes.c_uint32),
        ("prev_time", ctypes.c_uint64),
        ("prev_delta", ctypes.c_uint64),
        ("prev_float_bits", ctypes.c_uint64),
        ("prev_xor", ctypes.c_uint64),
        ("int_val", ctypes.c_uint64),
        ("time_unit", ctypes.c_uint8),
        ("sig", ctypes.c_uint8),
        ("mult", ctypes.c_uint8),
        ("is_float", ctypes.c_uint8),
        ("flags", ctypes.c_uint8),  # bit 0: int-fast chunk; bit 1: float-fast
    ]


# the same records as a numpy dtype, so that a batch's snapshots are read as
# columns (one conversion a field) rather than one ctypes struct at a time
SNAP_DTYPE = np.dtype({
    "names": [f for f, _ in _SnapRec._fields_],
    "formats": [np.uint32, *[np.uint64] * 5, *[np.uint8] * 5],
    "offsets": [getattr(_SnapRec, f).offset for f, _ in _SnapRec._fields_],
    "itemsize": ctypes.sizeof(_SnapRec),
})


def load() -> ctypes.CDLL:
    """The loaded library (built with g++ on the first call; raises if the
    build fails)."""
    return _build.load_library("m3tsz")


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(os.cpu_count() or 1, 16)


def _concat(blobs: list) -> tuple[np.ndarray, np.ndarray]:
    """Byte strings -> (their concatenation as uint8, offsets int64[n + 1])."""
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, blobs), np.int64, len(blobs)), out=offsets[1:])
    data = b"".join(blobs)
    return (np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)), offsets


def _encode_batch_native(lib, times, values, lengths, default_unit, int_optimized, n_threads, cap):
    out_buf = np.empty(cap, np.uint8)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    total = lib.m3tsz_encode_batch(
        times.ctypes.data, values.ctypes.data, lengths.ctypes.data, len(lengths),
        default_unit, 1 if int_optimized else 0, out_buf.ctypes.data, cap,
        offsets.ctypes.data, n_threads,
    )
    if total == -1:
        raise ValueError(f"m3tsz encode failed: unit {default_unit} has no time encoding scheme")
    return total, out_buf, offsets


def encode_batch(
    times: np.ndarray,
    values: np.ndarray,
    lengths: np.ndarray,
    default_unit: int = 1,
    int_optimized: bool = True,
    n_threads: int = 0,
) -> list[bytes]:
    """Encode N series (concatenated columns) -> list of finalized streams,
    byte for byte ``codec/m3tsz.encode_series`` of each. Raises ValueError
    where that raises (a default unit without a time encoding scheme)."""
    lib = load()
    times = np.ascontiguousarray(times, np.int64)
    values = np.ascontiguousarray(values, np.float64)
    lengths = np.ascontiguousarray(lengths, np.int32)
    n = len(lengths)
    if (lengths < 0).any() or int(lengths.sum()) != times.size or values.size != times.size:
        raise ValueError(f"lengths sum to {int(lengths.sum())} for {times.size} times and "
                         f"{values.size} values")
    cap = max(int(times.size * 16 + n * 16 + 1024), 4096)
    total, out_buf, offsets = _encode_batch_native(
        lib, times, values, lengths, default_unit, int_optimized, _threads(n_threads), cap
    )
    if total < 0:  # grow to the exact required size and retry once
        total, out_buf, offsets = _encode_batch_native(
            lib, times, values, lengths, default_unit, int_optimized, _threads(n_threads), -total
        )
    raw = out_buf[:total].tobytes()
    return [raw[offsets[i] : offsets[i + 1]] for i in range(n)]


def prescan_records(
    streams: list[bytes],
    k: int = 32,
    default_unit: int = 1,
    int_optimized: bool = True,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """The library's side-table prescan alone: (records SNAP_DTYPE[n,
    max_snaps], counts int32[n]); series i's snapshots are
    ``records[i, :counts[i]]``. ``prescan_batch`` turns them into dicts."""
    lib = load()
    n = len(streams)
    arr, offsets = _concat(streams)
    max_len = max((len(s) for s in streams), default=0)
    # record lower bound ~3 bits, so snapshots per stream are bounded by this
    max_snaps = max((max_len * 8) // max(3 * k, 1) + 2, 2)
    recs = np.empty((n, max_snaps), SNAP_DTYPE)
    counts = np.zeros(n, np.int32)
    if n:
        lib.m3tsz_prescan_batch(
            arr.ctypes.data, offsets.ctypes.data, n, k, default_unit,
            1 if int_optimized else 0, recs.ctypes.data, max_snaps, counts.ctypes.data,
            _threads(n_threads),
        )
    return recs, counts


def snapshot_dicts(streams: list[bytes], recs: np.ndarray, counts: np.ndarray) -> list[list[dict]]:
    """``prescan_records``' output as ``ops/chunked.snapshot_stream``'s
    per-series snapshot dict lists (13 keys a snapshot, ``span`` the bits to
    the next snapshot or the stream's end)."""
    counts = np.maximum(counts.astype(np.int64), 0)
    flat = recs[np.arange(recs.shape[1])[None, :] < counts[:, None]]  # series order
    total_bits = np.fromiter(map(len, streams), np.int64, len(streams)) * 8
    series_bits = np.repeat(total_bits, counts)
    off = flat["off"].astype(np.int64)
    nxt = np.empty_like(off)
    nxt[:-1] = off[1:]
    last = np.cumsum(counts) - 1
    nxt[last[counts > 0]] = series_bits[last[counts > 0]]
    flags = flat["flags"]
    fields = zip(
        off.tolist(), flat["prev_time"].tolist(), flat["prev_delta"].tolist(),
        flat["prev_float_bits"].tolist(), flat["prev_xor"].tolist(), flat["int_val"].tolist(),
        flat["time_unit"].tolist(), flat["sig"].tolist(), flat["mult"].tolist(),
        (flat["is_float"] != 0).tolist(), ((flags & 1) != 0).tolist(),
        ((flags & 2) != 0).tolist(),
        series_bits.tolist(), (nxt - off).tolist(),
    )
    snaps = [
        dict(off=o, prev_time=pt, prev_delta=pd, prev_float_bits=pf, prev_xor=px, int_val=iv,
             time_unit=tu, sig=sg, mult=m, is_float=isf, fast=f, fast_float=ff,
             total_bits=tb, span=sp)
        for o, pt, pd, pf, px, iv, tu, sg, m, isf, f, ff, tb, sp in fields
    ]
    out, pos = [], 0
    for c in counts.tolist():
        out.append(snaps[pos : pos + c])
        pos += c
    return out


def prescan_batch(
    streams: list[bytes],
    k: int = 32,
    default_unit: int = 1,
    int_optimized: bool = True,
    n_threads: int = 0,
) -> list[list[dict]]:
    """Side-table prescan for N streams -> per-series snapshot dict lists
    (the same as ``ops.chunked.snapshot_stream`` of each)."""
    if not streams:
        return []
    recs, counts = prescan_records(streams, k, default_unit, int_optimized, n_threads)
    return snapshot_dicts(streams, recs, counts)


def window_keys(
    ids: np.ndarray,
    times_nanos: np.ndarray,
    window0_nanos: int,
    resolution_nanos: int,
    n_windows: int,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """The library's window bucketing (``m3agg_window_keys``): (keys
    int32[n] = id * n_windows + window, torder int32[n]). Raises ValueError
    where a key would pass INT32_MAX (the JAX package's library wraps it)."""
    if resolution_nanos <= 0 or n_windows <= 0:
        raise ValueError(f"resolution {resolution_nanos} and n_windows {n_windows} must be > 0")
    ids = np.ascontiguousarray(ids, np.int64)
    times_nanos = np.ascontiguousarray(times_nanos, np.int64)
    if ids.shape != times_nanos.shape:
        raise ValueError(f"{ids.shape[0]} ids for {times_nanos.shape[0]} times")
    keys = np.empty(len(ids), np.int32)
    torder = np.empty(len(ids), np.int32)
    if load().m3agg_window_keys(
        ids.ctypes.data, times_nanos.ctypes.data, len(ids), window0_nanos, resolution_nanos,
        n_windows, keys.ctypes.data, torder.ctypes.data, _threads(n_threads),
    ) != 0:
        raise ValueError(f"a group key id * {n_windows} + window passes INT32_MAX")
    return keys, torder


def pack_windowed_dense(
    ids: np.ndarray,
    times_nanos: np.ndarray,
    values: np.ndarray,
    window0_nanos: int,
    resolution_nanos: int,
    n_windows: int,
    n_series: int,
    n_threads: int = 0,
):
    """Fused window bucketing + dense [G, P] pack for the rollup kernels
    (``aggregator/kernels.py``): keys/torder, counts and the arrival-order
    dense scatter in three memory-bound C++ passes. Returns (vals[G, P] f32,
    torder[G, P] i32, valid[G, P] bool), equal to the numpy path
    (``aggregator/kernels.window_keys`` + ``pack_dense_groups``). Grids of
    more than INT32_MAX groups take that numpy path (int64 keys), as in the
    reference."""
    n = len(ids)
    n_groups = n_series * n_windows
    if n_groups > np.iinfo(np.int32).max:
        from ..aggregator.kernels import pack_dense_groups
        from ..aggregator.kernels import window_keys as np_window_keys

        keys, _, order = np_window_keys(
            np.asarray(ids), np.asarray(times_nanos), window0_nanos, resolution_nanos, n_windows,
        )
        return pack_dense_groups(keys, values, order, n_groups)
    lib = load()
    threads = _threads(n_threads)
    keys, torder = window_keys(ids, times_nanos, window0_nanos, resolution_nanos, n_windows,
                               threads)
    values = np.ascontiguousarray(values, np.float32)
    counts = np.zeros(n_groups, np.int32)
    p = int(lib.m3agg_count(keys.ctypes.data, n, n_groups, counts.ctypes.data, threads))
    if p < 0:
        raise ValueError(f"a series id lies outside [0, {n_series})")
    p = max(p, 1)
    vals = np.empty((n_groups, p), np.float32)
    tor = np.empty((n_groups, p), np.int32)
    lib.m3agg_pack(
        keys.ctypes.data, values.ctypes.data, torder.ctypes.data, n, n_groups, p,
        counts.ctypes.data, vals.ctypes.data, tor.ctypes.data, threads,
    )
    # as the numpy path: a NaN value (a stale marker) occupies a slot but is
    # not valid
    valid = (np.arange(p, dtype=np.int32)[None, :] < counts[:, None]) & ~np.isnan(vals)
    return vals, tor, valid


def decode_batch(
    streams: list[bytes],
    default_unit: int = 1,
    int_optimized: bool = True,
    n_threads: int = 0,
    max_points: int | None = None,
    with_flags: bool = False,
):
    """Batch-decode N m3tsz streams -> list of (times i64[n], values f64[n],
    units u8[n]) numpy triples, the points ``codec/m3tsz.decode`` gives.
    Annotations do not alter (t, v, u); with ``with_flags`` the return is
    (triples, flags u8[n]) where bit 0 marks streams that carry annotations,
    so callers that must surface them re-decode those through the Python
    iterator. ``max_points`` caps the points a stream (callers that decode
    many streams pass it: the default capacity is 4 points a stream byte, 17
    bytes a point); a stream that holds more is decoded again at the safe
    capacity. A stream the decoder rejects raises ValueError.

    Reference: the Go iterator's batch decode role
    (src/dbnode/encoding/m3tsz/iterator.go:64)."""
    lib = load()
    n = len(streams)
    if n == 0:
        return ([], np.zeros(0, np.uint8)) if with_flags else []
    arr, offsets = _concat(streams)
    # one point per 2 encoded bits is unreachable by the format (a record
    # takes at least 3 bits), so bits // 2 + 2 never overflows
    cap = max_points or max(int(max(len(s) for s in streams)) * 4 + 2, 4)
    times = np.empty((n, cap), np.int64)
    values = np.empty((n, cap), np.float64)
    units = np.empty((n, cap), np.uint8)
    counts = np.zeros(n, np.int64)
    flags = np.zeros(n, np.uint8)
    failed = lib.m3tsz_decode_batch(
        arr.ctypes.data, offsets.ctypes.data, n, default_unit, 1 if int_optimized else 0, cap,
        times.ctypes.data, values.ctypes.data, units.ctypes.data, counts.ctypes.data,
        flags.ctypes.data, _threads(n_threads),
    )
    if failed:
        if max_points is not None and (counts == -2).any():
            # the caller's cap was too small somewhere: retry with the safe bound
            return decode_batch(
                streams, default_unit=default_unit, int_optimized=int_optimized,
                n_threads=n_threads, max_points=None, with_flags=with_flags,
            )
        bad = np.flatnonzero(counts < 0)
        raise ValueError(f"m3tsz decode failed for {len(bad)} streams (first: {bad[:3].tolist()})")
    triples = [
        (times[i, :c].copy(), values[i, :c].copy(), units[i, :c].copy())
        for i, c in enumerate(counts.tolist())
    ]
    return (triples, flags) if with_flags else triples


def encode_one(
    times: np.ndarray,
    values: np.ndarray,
    units: np.ndarray | None = None,
    default_unit: int = 1,
    int_optimized: bool = True,
) -> bytes:
    """Encode ONE series with optional per-point units
    (``m3tsz_encode_series``), byte for byte the Python ``Encoder``'s
    stream. Raises ValueError where that encoder raises: a point whose unit
    has no time encoding scheme. The buffer bucket's merge
    (``storage/series.py``) is the hot caller."""
    lib = load()
    times = np.ascontiguousarray(times, np.int64)
    values = np.ascontiguousarray(values, np.float64)
    n = len(times)
    if len(values) != n or (units is not None and len(units) != n):
        raise ValueError(f"{n} times, {len(values)} values and "
                         f"{'no' if units is None else len(units)} units")
    if n == 0:
        return b""
    u_ptr = None
    if units is not None:
        units = np.ascontiguousarray(units, np.int32)
        u_ptr = units.ctypes.data
    cap = n * 16 + 1024
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        r = int(lib.m3tsz_encode_series(
            times.ctypes.data, values.ctypes.data, n, default_unit, u_ptr,
            1 if int_optimized else 0, out.ctypes.data, cap,
        ))
        if r >= 0:
            return out[:r].tobytes()
        if r == -1:
            raise ValueError("m3tsz encode failed: a point's unit has no time encoding scheme")
        cap = -r
    raise RuntimeError(f"m3tsz_encode_series asked for {cap} bytes twice")


def shard_batch(ids: list[bytes], num_shards: int) -> np.ndarray:
    """murmur3-32 shard routing for a batch of series ids in one call
    (sharding/shardset.go DefaultHashFn), equal to ``utils/hash.shard_for``
    of each id."""
    if num_shards < 1:
        raise ValueError(f"num_shards {num_shards} must be >= 1")
    lib = load()
    arr, offsets = _concat(ids)
    out = np.empty(len(ids), np.int32)
    lib.m3hash_shards(arr.ctypes.data, offsets.ctypes.data, len(ids), num_shards, out.ctypes.data)
    return out
