"""Chunked M3TSZ lanes: host prescan, side tables and the records decode.

Port of ``m3_tpu/ops/chunked.py``. Streams are split into chunks of k
records; each chunk carries a snapshot of the decoder state at its start,
so the device decodes S×C independent chunk-lanes of at most k records
each. The host half (prescan, side tables) is numpy. The device half
decodes packed lanes (``ops/fused.pack_lanes``) to per-record timestamps
and value bits: ``decode_chunked_lanes`` launches kernel R for CUDA tensors
and runs its twin for CPU tensors. The lane decode + fold is
``ops/fused.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.m3tsz import DEFAULT_INT_OPTIMIZATION, ReaderIterator
from ..utils.xtime import Unit, initial_time_unit
from . import decode as D
from . import fused

# Decoder-state fields stored as (hi, lo) uint32 pairs.
STATE_PAIR_FIELDS = ("prev_time", "prev_delta", "prev_float_bits", "prev_xor", "int_val")
# Every per-lane field of ChunkedBatch, in the reference's lane order.
LANE_FIELDS = (
    "windows",
    "rel_pos",
    "num_bits",
    "first",
    *STATE_PAIR_FIELDS,
    "time_unit",
    "sig",
    "mult",
    "is_float",
)


def lane_kwargs(batch: "ChunkedBatch", transform=None) -> dict:
    """ChunkedBatch → dict of its lane fields; ``transform`` maps each array
    (applied to both halves of pair fields)."""
    t = transform or (lambda x: x)
    out = {}
    for f in LANE_FIELDS:
        v = getattr(batch, f)
        out[f] = (t(v[0]), t(v[1])) if f in STATE_PAIR_FIELDS else t(v)
    return out


def _split64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    x = x.astype(np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclass
class ChunkedBatch:
    """Flattened [S*C] chunk lanes (series-major) + per-chunk decoder-state
    side table."""

    windows: np.ndarray  # uint32[N, CW]
    rel_pos: np.ndarray  # int32[N] bit offset of chunk start within window
    num_bits: np.ndarray  # int32[N] window-relative valid bit bound
    first: np.ndarray  # bool[N] first chunk of its series
    prev_time: tuple  # (hi, lo) uint32[N]
    prev_delta: tuple
    prev_float_bits: tuple
    prev_xor: tuple
    int_val: tuple
    time_unit: np.ndarray  # int32[N]
    sig: np.ndarray
    mult: np.ndarray
    is_float: np.ndarray  # bool[N]
    k: int
    num_series: int
    num_chunks: int  # C per series (uniform, zero-padded)
    # chunks the device may decode with the int-only body (all-int,
    # marker-free, constant {s,ms} unit, exactly k records, int32-safe);
    # empty padding lanes are fast=True so they never force a tile slow
    fast: np.ndarray = None  # bool[N]
    # float-mode analogue: marker-free XOR/repeat records, float at chunk
    # start and after every record
    fast_float: np.ndarray = None  # bool[N]


def from_numpy_fields(fields: dict) -> ChunkedBatch:
    """Build a ChunkedBatch from plain numpy arrays, e.g. the fields of the
    JAX package's ChunkedBatch passed as a dict, so both packages can be fed
    the same side tables. Pair fields are (hi, lo) tuples."""
    kw = {}
    for f in LANE_FIELDS:
        v = fields[f]
        if f in STATE_PAIR_FIELDS:
            kw[f] = (np.asarray(v[0], np.uint32), np.asarray(v[1], np.uint32))
        elif f in ("first", "is_float"):
            kw[f] = np.asarray(v, bool)
        elif f == "windows":
            kw[f] = np.asarray(v, np.uint32)
        else:
            kw[f] = np.asarray(v, np.int32)
    for f in ("fast", "fast_float"):
        kw[f] = None if fields.get(f) is None else np.asarray(fields[f], bool)
    return ChunkedBatch(
        **kw,
        k=int(fields["k"]),
        num_series=int(fields["num_series"]),
        num_chunks=int(fields["num_chunks"]),
    )


def snapshot_stream(
    data: bytes,
    k: int,
    int_optimized: bool = DEFAULT_INT_OPTIMIZATION,
    default_unit: Unit = Unit.SECOND,
) -> list[dict]:
    """Host prescan of one stream: decoder-state snapshot every ``k``
    records, plus the per-chunk fast/fast_float classification that picks
    the kernel body (see ChunkedBatch)."""
    it = ReaderIterator(data, int_optimized=int_optimized, default_unit=default_unit)
    per: list[dict] = []
    nrec = 0
    total_bits = len(data) * 8
    # fast: every record of the chunk is a marker-free int-mode record with
    # a constant {s, ms} unit. fast_float: every record marker-free and
    # float-mode with the chunk already in float mode at its start, so the
    # device sees only "1"+XOR or "01" repeat records (an int→float
    # transition record carries a full float the float body cannot parse).
    chunk_fast = True
    chunk_fast_float = True
    chunk_start_float = False
    chunk_recs = 0

    def snap():
        st = it.stream
        ts = it.ts_iterator
        unit = ts.time_unit
        if nrec == 0 and len(data) >= 8:
            nt = int.from_bytes(data[:8], "big")
            unit = initial_time_unit(nt, default_unit)
        return dict(
            off=st.byte_pos * 8 + st.bit_pos,
            prev_time=ts.prev_time & 0xFFFFFFFFFFFFFFFF,
            prev_delta=ts.prev_time_delta & 0xFFFFFFFFFFFFFFFF,
            time_unit=int(unit),
            prev_float_bits=it.float_iter.prev_float_bits,
            prev_xor=it.float_iter.prev_xor,
            int_val=int(it.int_val) & 0xFFFFFFFFFFFFFFFF,
            sig=it.sig,
            mult=it.mult,
            is_float=it.is_float,
        )

    while True:
        pending = snap() if nrec % k == 0 else None
        if pending is not None and per:
            # the previous chunk just completed all k records: seal its flags
            per[-1]["fast"] = chunk_fast and chunk_recs == k
            per[-1]["fast_float"] = (
                chunk_fast_float and chunk_start_float and chunk_recs == k
            )
        if pending is not None:
            chunk_fast, chunk_recs = True, 0
            chunk_fast_float = True
            chunk_start_float = bool(it.is_float) and int_optimized
        markers_before = it.ts_iterator.num_markers
        if not it.next():
            # no record followed: don't emit an empty trailing chunk
            break
        if pending is not None:
            per.append(pending)
        nrec += 1
        chunk_recs += 1
        marker_seen = it.ts_iterator.num_markers != markers_before
        unit_ok = int(it.ts_iterator.time_unit) in (
            int(Unit.SECOND), int(Unit.MILLISECOND)
        )
        if (
            marker_seen
            or it.is_float
            or not unit_ok
            or not int_optimized
            # int32-safety: the int body runs in 32-bit (sig <= 31, value in
            # i32 range after every record)
            or it.sig > 31
            or abs(it.int_val) > 2147483647
        ):
            chunk_fast = False
        if marker_seen or not it.is_float or not unit_ok or not int_optimized:
            chunk_fast_float = False
        if it.ts_iterator.done or it.err is not None:
            break
    if per and chunk_recs > 0:
        # seal the trailing chunk; a break exactly on a boundary means the
        # last chunk was already sealed above
        per[-1]["fast"] = chunk_fast and chunk_recs == k
        per[-1]["fast_float"] = (
            chunk_fast_float and chunk_start_float and chunk_recs == k
        )
    offs = [p["off"] for p in per] + [total_bits]
    for i, p in enumerate(per):
        p["span"] = offs[i + 1] - offs[i]
        p["total_bits"] = total_bits
        p.setdefault("fast", False)
        p.setdefault("fast_float", False)
    return per


def window_words(max_span_bits: int, min_window_words: int = 0) -> int:
    """Window width (uint32 words) covering the widest chunk span plus 4
    lookahead words and up to 31 bits of alignment slack."""
    cw = (31 + max_span_bits + 31) // 32 + 4
    return max(cw, min_window_words, 6)


def assemble_chunked(
    streams: list[bytes], snaps: list[list[dict]], k: int, min_window_words: int = 0
) -> ChunkedBatch:
    """Pack streams + per-chunk snapshots into the dense lane arrays."""
    s = len(streams)
    c = max((len(p) for p in snaps), default=1)
    c = max(c, 1)
    n = s * c
    max_span = max((p["span"] for per in snaps for p in per), default=0)
    cw = window_words(max_span, min_window_words)

    windows = np.zeros((n, cw), np.uint32)
    rel = np.zeros(n, np.int32)
    nbits = np.zeros(n, np.int32)
    first = np.zeros(n, bool)
    pt = np.zeros(n, np.uint64)
    pd = np.zeros(n, np.uint64)
    pfb = np.zeros(n, np.uint64)
    pxr = np.zeros(n, np.uint64)
    iv = np.zeros(n, np.uint64)
    tu = np.zeros(n, np.int32)
    sig = np.zeros(n, np.int32)
    mult = np.zeros(n, np.int32)
    isf = np.zeros(n, bool)
    fast = np.ones(n, bool)  # empty padding lanes stay fast
    fast_float = np.ones(n, bool)  # likewise

    for si, (data, per) in enumerate(zip(streams, snaps)):
        padded = (
            np.frombuffer(data + b"\x00" * (-len(data) % 4), dtype=">u4").astype(np.uint32)
            if data
            else np.zeros(0, np.uint32)
        )
        for ci, p in enumerate(per):
            i = si * c + ci
            w0 = p["off"] >> 5
            rel[i] = p["off"] & 31
            seg = padded[w0 : w0 + cw]
            windows[i, : len(seg)] = seg
            nbits[i] = max(0, min(p["total_bits"] - (w0 << 5), cw * 32))
            first[i] = ci == 0
            pt[i] = p["prev_time"]
            pd[i] = p["prev_delta"]
            pfb[i] = p["prev_float_bits"]
            pxr[i] = p["prev_xor"]
            iv[i] = p["int_val"]
            tu[i] = p["time_unit"]
            sig[i] = p["sig"]
            mult[i] = p["mult"]
            isf[i] = p["is_float"]
            # the first chunk decodes the 64-bit head + first-value format
            # the fast bodies don't implement
            fast[i] = bool(p.get("fast", False)) and ci != 0
            fast_float[i] = bool(p.get("fast_float", False)) and ci != 0

    return ChunkedBatch(
        windows=windows,
        rel_pos=rel,
        num_bits=nbits,
        first=first,
        prev_time=_split64(pt),
        prev_delta=_split64(pd),
        prev_float_bits=_split64(pfb),
        prev_xor=_split64(pxr),
        int_val=_split64(iv),
        time_unit=tu,
        sig=sig,
        mult=mult,
        is_float=isf,
        k=k,
        num_series=s,
        num_chunks=c,
        fast=fast,
        fast_float=fast_float,
    )


def build_chunked(
    streams: list[bytes],
    k: int = 32,
    int_optimized: bool = DEFAULT_INT_OPTIMIZATION,
    default_unit: Unit = Unit.SECOND,
    min_window_words: int = 0,
) -> ChunkedBatch:
    """Prescan (pure Python, snapshot_stream) + assemble."""
    snaps = [
        snapshot_stream(d, k, int_optimized=int_optimized, default_unit=default_unit)
        for d in streams
    ]
    return assemble_chunked(streams, snaps, k, min_window_words=min_window_words)


def _rebatch(batch: ChunkedBatch, t, num_series: int, flag_t=None) -> ChunkedBatch:
    flag_t = flag_t or t
    return ChunkedBatch(
        **lane_kwargs(batch, transform=t),
        k=batch.k,
        num_series=num_series,
        num_chunks=batch.num_chunks,
        fast=flag_t(batch.fast) if batch.fast is not None else None,
        fast_float=flag_t(batch.fast_float) if batch.fast_float is not None else None,
    )


def tile_chunked(batch: ChunkedBatch, n_series: int) -> ChunkedBatch:
    """Tile a small unique batch up to n_series (series i repeats unique
    series i % S). On the main path ``fused.pack_lanes(..., n_series=)``
    does the same tiling on the device instead of materializing it here."""
    reps = -(-n_series // batch.num_series)
    cut = n_series * batch.num_chunks

    def t(x):
        x = np.asarray(x)
        return np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:cut]

    return _rebatch(batch, t, n_series)


def pad_series(batch: ChunkedBatch, multiple: int) -> ChunkedBatch:
    """Pad with EMPTY series (zero-bit lanes decode zero records, fast=True)
    so the series count divides ``multiple``."""
    pad = (-batch.num_series) % multiple
    if pad == 0:
        return batch
    n_new = pad * batch.num_chunks

    def t(x):
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((n_new,) + x.shape[1:], x.dtype)])

    def flags(x):
        return np.concatenate([np.asarray(x), np.ones(n_new, bool)])

    return _rebatch(batch, t, batch.num_series + pad, flag_t=flags)


def select_series(batch: ChunkedBatch, series_idx) -> ChunkedBatch:
    """A new ChunkedBatch holding only the selected series (host gather over
    the series-major lane layout)."""
    sel = np.asarray(series_idx, np.int64)
    c = batch.num_chunks
    lanes = (sel[:, None] * c + np.arange(c)[None, :]).ravel()
    return _rebatch(batch, lambda x: np.take(np.asarray(x), lanes, axis=0), int(sel.size))


# ---------------------------------------------------------------------------
# Device half: chunk-lanes decoded to records (kernel R and its twin)
# ---------------------------------------------------------------------------

# Launches of kernel R, counted by decode_chunked_lanes where it launches.
LAUNCHES = 0

# lanes per block of the twin: bounds its temporaries at full size
_TWIN_BLOCK_LANES = 1 << 20


def decode_chunked_lanes(windows, lanes, n: int, k: int) -> D.DecodeResult:
    """Decode k records of each of the first ``n`` lanes with the general
    body (m3_tpu/ops/chunked.py:460 decode_chunked_lanes, int_optimized).
    Records come out lane-major, [n, k]; ``err`` is per lane.

    For CUDA tensors this launches kernel R (``csrc/lane_aggregates.cu``
    m3_decode_records) and raises if the build or the launch fails; for CPU
    tensors it runs the plain twin."""
    fused.check_lanes(windows, lanes, n, k)
    if windows.device.type == "cpu":
        return decode_chunked_lanes_reference(windows, lanes, n, k)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    if n == 0:  # nothing to launch: empty records
        return decode_chunked_lanes_reference(windows, lanes, n, k)
    return _launch_records(windows, lanes, n, k)


def _launch_records(windows, lanes, n, k) -> D.DecodeResult:
    global LAUNCHES
    import ctypes

    from ._build import load_library

    lib = load_library("lane_aggregates")
    windows = windows.contiguous()
    lanes = lanes.contiguous()
    cw, npad = windows.shape
    dev = windows.device
    ts = torch.empty((n, k), dtype=torch.int64, device=dev)
    bits = torch.empty((n, k), dtype=torch.int64, device=dev)
    small = torch.empty((3, n, k), dtype=torch.uint8, device=dev)  # pif, mult, valid
    err = torch.empty(n, dtype=torch.uint8, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_decode_records(
            ptr(windows), ptr(lanes), ctypes.c_int64(npad), ctypes.c_int64(n),
            ctypes.c_int(cw), ctypes.c_int(D.barrel_mask(cw)), ctypes.c_int(k),
            ptr(ts), ptr(bits), ptr(small[0]), ptr(small[1]), ptr(small[2]), ptr(err),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"decode_records kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return D.DecodeResult(
        ts=ts, bits=bits, point_is_float=small[0].view(torch.bool), mult=small[1],
        valid=small[2].view(torch.bool), err=err.view(torch.bool),
    )


def decode_chunked_lanes_reference(windows, lanes, n: int, k: int) -> D.DecodeResult:
    """Plain PyTorch version of kernel R, on any device: the record step of
    ops/decode.py run with the general body on every lane, in blocks."""
    fused.check_lanes(windows, lanes, n, k)
    dev = windows.device
    ts = torch.empty((n, k), dtype=torch.int64, device=dev)
    bits = torch.empty((n, k), dtype=torch.int64, device=dev)
    pif = torch.empty((n, k), dtype=torch.bool, device=dev)
    mult = torch.empty((n, k), dtype=torch.uint8, device=dev)
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    err = torch.zeros(n, dtype=torch.bool, device=dev)
    for start in range(0, n, _TWIN_BLOCK_LANES):
        rows = slice(start, min(start + _TWIN_BLOCK_LANES, n))
        fetch, ln = fused.lane_inputs(windows, lanes, rows)
        for idx, (ok, st) in enumerate(fused.walk_general(fetch, ln, k)):
            ts[rows, idx] = D.pair_to_i64(st.prev_time)
            bits[rows, idx] = D.pair_to_i64(D.pair_select(st.is_float, st.prev_float_bits, st.int_val))
            pif[rows, idx] = st.is_float
            mult[rows, idx] = st.mult.to(torch.uint8)
            valid[rows, idx] = ok
        err[rows] = st.err
    return D.DecodeResult(ts=ts, bits=bits, point_is_float=pif, mult=mult, valid=valid, err=err)


def decode_chunked(windows, lanes, s: int, c: int, k: int) -> D.DecodeResult:
    """Decode the lanes of ``s`` series, ``c`` chunk-lanes each, laid out
    series-major (lane = series * c + chunk, as ``fused.pack_lanes(order="s")``
    packs them), to per-series rows [S, C*K] (chunked.py:550
    decode_chunked); ``err`` is per series."""
    res = decode_chunked_lanes(windows, lanes, n=s * c, k=k)
    rs = lambda x: x.reshape(s, c * k)
    return D.DecodeResult(
        ts=rs(res.ts), bits=rs(res.bits), point_is_float=rs(res.point_is_float),
        mult=rs(res.mult), valid=rs(res.valid), err=res.err.reshape(s, c).any(dim=1),
    )
