"""Fused chunked decode + aggregation: the CUDA lane-aggregate kernel.

Port of ``m3_tpu/ops/fused.py`` (``pack_lane_inputs`` and the Pallas kernel
``lane_aggregates_packed``). Each chunk-lane decodes its k M3TSZ records
from its side-table state and folds every value into f32
sum/count/min/max/last plus an err flag; only those six per-lane values
leave the kernel.

- ``pack_lanes`` lays the lanes out for the GPU: word-major windows
  ``[CW, Npad]`` and state planes ``[17, Npad]``, so neighbouring threads
  read neighbouring addresses. Lane order, tile size (rows × 128 lanes),
  ``tile_flags`` and ``inv`` are exactly ``pack_lane_inputs``'s.
- ``lane_aggregates`` launches the kernel (``csrc/lane_aggregates.cu``)
  for CUDA tensors and runs ``lane_aggregates_reference`` for CPU tensors.
- ``lane_aggregates_reference`` is the plain PyTorch twin of the three
  kernel bodies, chosen per tile by ``tile_flags`` as the reference does:
  0 general, 1 every lane int-fast, 2 every lane float-fast.
- ``lane_aggregates_fields`` is B3, the port of ``lane_aggregates_pallas``:
  the general body on every lane of the per-field layout (lane-major
  windows [N, CW] and one array per field); ``lane_aggregates_fields_
  reference`` is its twin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import device_guard, resolve_device
from ..utils.instrument import KernelProfiler
from . import decode as D

# rows per tile: a tile is rows x 128 lanes and shares one body
ROWS_DEFAULT = 32

# Order of the state planes in the packed lane array (fused.py
# PACKED_LANE_PLANES).
PACKED_LANE_PLANES = (
    "rel_pos", "num_bits", "first",
    "prev_time_hi", "prev_time_lo", "prev_delta_hi", "prev_delta_lo",
    "prev_float_bits_hi", "prev_float_bits_lo", "prev_xor_hi", "prev_xor_lo",
    "int_val_hi", "int_val_lo",
    "time_unit", "sig", "mult", "is_float",
)
NLANE = len(PACKED_LANE_PLANES)

# Launches of the CUDA kernel, counted by lane_aggregates where it launches.
LAUNCHES = 0

# dispatch observability for the two lane-aggregate paths (the per-field
# B3 and the packed B1), at their seams in parallel/scan.py
PROFILER_FUSED = KernelProfiler("fused_lane_agg")
PROFILER_PACKED = KernelProfiler("packed_lane_agg")

# Kernel inputs copied into fresh storage because a kernel needs them
# 16-byte aligned and they were not (a view at an odd offset), by
# kernel_input; chip_smoke.py prints it, and 0 is expected on every path.
UNALIGNED_COPIES = 0

# the lane kernels of csrc/lane_aggregates.cu, as its m3_lane_smem_bytes and
# m3_lane_resident_blocks number them
LANE_KERNELS = {"lane_aggregates": 0, "decode_records": 1, "lane_aggregates_fields": 2}


class LaneAggregates(NamedTuple):
    """Per-lane (= per chunk) reductions."""

    sum: torch.Tensor  # f32[N]
    count: torch.Tensor  # i32[N]
    min: torch.Tensor  # f32[N] (+inf where empty)
    max: torch.Tensor  # f32[N] (-inf where empty)
    last: torch.Tensor  # f32[N] (NaN where empty)
    err: torch.Tensor  # bool[N]


class PackedLanes(NamedTuple):
    """Kernel inputs on one device (see pack_lanes)."""

    windows: torch.Tensor  # int32[CW, Npad]: u32 words, word-major
    lanes: torch.Tensor  # int32[NLANE, Npad]: u32 state planes
    tile_flags: torch.Tensor  # int32[tiles]: 0 general, 1 int-fast, 2 float-fast
    n: int  # true lane count (before tile padding)
    order: str  # "c" (chunk-major), "s" (series-major), "sorted"
    inv: np.ndarray | None = None  # "sorted": int32[S]; series i sits at row inv[i]


def _as_i32(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return x.astype(np.int32)
    return x.astype(np.uint32 if x.dtype == np.uint32 else np.int32, copy=False).view(np.int32)


def _plane(batch, name):
    if name.endswith("_hi") or name.endswith("_lo"):
        pair = getattr(batch, name[:-3])
        return pair[0] if name.endswith("_hi") else pair[1]
    return getattr(batch, name)


def pack_lanes(batch, order: str = "c", rows: int = ROWS_DEFAULT,
               device="cuda", n_series: int | None = None) -> PackedLanes:
    """Lay a ChunkedBatch's lanes out for the kernel on ``device``.

    ``order``: "c" chunk-major (lane j = chunk * S + series), so fast chunks
    of one chunk position share tiles; "s" series-major; "sorted"
    chunk-major with series grouped by their dominant fast class
    (int-fast, float-fast, slow), so mixed workloads still fill homogeneous
    tiles. ``n_series`` tiles the batch's series up to that count on the
    device (series i repeats series i % S, as ``chunked.tile_chunked``),
    so the host never holds the full-size lane arrays."""
    dev = resolve_device(device)
    if order not in ("c", "s", "sorted"):
        raise ValueError(f"order must be 'c', 's' or 'sorted', got {order!r}")
    if rows <= 0 or rows % 8:
        raise ValueError(f"rows must be a positive multiple of 8, got {rows}")
    s_u, c = batch.num_series, batch.num_chunks
    s = s_u if n_series is None else int(n_series)
    windows = np.asarray(batch.windows, np.uint32)
    n_u, cw = windows.shape
    n = s * c
    tile_lanes = rows * 128
    tiles = -(-n // tile_lanes)
    npad = tiles * tile_lanes

    inv = None
    perm = None
    if order == "sorted":
        def per_series(flags):
            if flags is None:
                return np.zeros(s, np.int64)
            cnt = np.asarray(flags, bool).reshape(s_u, c).sum(axis=1)
            return cnt[np.arange(s) % s_u]

        int_cnt = per_series(getattr(batch, "fast", None))
        flt_cnt = per_series(getattr(batch, "fast_float", None))
        group = np.where(
            (int_cnt > 0) & (int_cnt >= flt_cnt), 0, np.where(flt_cnt > 0, 1, 2)
        )
        perm = np.argsort(group, kind="stable")
        inv = np.argsort(perm).astype(np.int32)

    # packed lane j -> source lane of the unique batch (n_u = zero lane)
    j = torch.arange(npad, device=dev)
    if order == "s":
        si, ci = j // c, j % c
    else:
        si, ci = j % s, j // s
        if perm is not None:
            si = torch.from_numpy(perm).to(dev)[si]
    src = torch.where(j < n, (si % s_u) * c + ci, n_u)
    del j, si, ci

    def gather(host_rows: np.ndarray) -> torch.Tensor:
        """[R, n_u] host int32 -> [R, npad] on dev, zero on padding lanes."""
        ext = np.zeros((host_rows.shape[0], n_u + 1), np.int32)
        ext[:, :n_u] = host_rows
        return torch.from_numpy(ext).to(dev)[:, src].contiguous()

    win = gather(np.ascontiguousarray(windows.T).view(np.int32))
    lanes = gather(np.stack([_as_i32(_plane(batch, p)) for p in PACKED_LANE_PLANES]))

    def tile_all(flags) -> torch.Tensor:
        if flags is None:
            return torch.zeros(tiles, dtype=torch.bool, device=dev)
        ext = np.ones(n_u + 1, bool)  # padding lanes never force a tile slow
        ext[:n_u] = np.asarray(flags, bool)
        lane_flags = torch.from_numpy(ext).to(dev)[src]
        return lane_flags.reshape(tiles, tile_lanes).all(dim=1)

    int_tiles = tile_all(getattr(batch, "fast", None))
    flt_tiles = tile_all(getattr(batch, "fast_float", None))
    tile_flags = torch.where(
        int_tiles, 1, torch.where(flt_tiles, 2, 0)
    ).to(torch.int32)
    return PackedLanes(
        windows=win, lanes=lanes, tile_flags=tile_flags, n=n, order=order, inv=inv,
    )


def check_lanes(windows, lanes, n, k):
    """Raise on packed lanes a kernel does not take."""
    if windows.dtype != torch.int32 or lanes.dtype != torch.int32:
        raise TypeError("windows and lanes must be int32 tensors of u32 bit patterns")
    if windows.dim() != 2 or lanes.dim() != 2 or lanes.shape[0] != NLANE:
        raise ValueError(f"want windows [CW, Npad] and lanes [{NLANE}, Npad]")
    if lanes.shape[1] != windows.shape[1] or not 0 <= n <= windows.shape[1]:
        raise ValueError("lane counts disagree")
    if lanes.device != windows.device:
        raise ValueError("windows and lanes lie on different devices")
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")


def _check_inputs(windows, lanes, tile_flags, n, k):
    check_lanes(windows, lanes, n, k)
    if tile_flags.dtype != torch.int32 or tile_flags.dim() != 1:
        raise TypeError("tile_flags must be int32[tiles]")
    tiles = tile_flags.shape[0]
    if tiles == 0 or windows.shape[1] % tiles:
        raise ValueError("Npad must be a multiple of the tile count")
    if (windows.shape[1] // tiles) % 128:
        # the kernel walks 128-lane slabs, each inside one tile
        raise ValueError("a tile must hold a multiple of 128 lanes")
    if tile_flags.device != windows.device:
        raise ValueError("tile_flags and windows lie on different devices")


def kernel_input(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels' 16-byte copies
    need: a misaligned tensor is copied into fresh storage and counted in
    UNALIGNED_COPIES."""
    global UNALIGNED_COPIES
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
        UNALIGNED_COPIES += 1
    return t


def check_launch_shape(lib, kernel: str, cw: int) -> None:
    """Raise ValueError, naming the shape, for windows of ``cw`` words that a
    block of ``kernel`` (a key of LANE_KERNELS) cannot stage in shared
    memory, as the kernel source ``lib`` was built from lays it out."""
    need = lib.m3_lane_smem_bytes(LANE_KERNELS[kernel], cw, D.barrel_mask(cw))
    most = lib.m3_lane_smem_max_bytes()
    if cw <= 0 or need > most:
        raise ValueError(
            f"{kernel}: windows of CW={cw} words need {need} bytes of shared memory a "
            f"block; a block may use {most}")


def lane_aggregates(windows, lanes, tile_flags, n: int, k: int) -> LaneAggregates:
    """Decode k records per lane and fold them into per-lane aggregates.

    For CUDA tensors this launches the kernel (and raises if the build or
    the launch fails); for CPU tensors it runs the plain twin."""
    _check_inputs(windows, lanes, tile_flags, n, k)
    if windows.device.type == "cpu":
        return lane_aggregates_reference(windows, lanes, tile_flags, n, k)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    return _launch(windows, lanes, tile_flags, n, k)


def _launch(windows, lanes, tile_flags, n, k) -> LaneAggregates:
    global LAUNCHES
    from ._build import launch_error, load_library

    lib = load_library("lane_aggregates")
    check_launch_shape(lib, "lane_aggregates", windows.shape[0])
    windows = kernel_input(windows)
    lanes = kernel_input(lanes)
    cw, npad = windows.shape
    dev = windows.device
    tile_flags = tile_flags.contiguous()
    tile_lanes = npad // tile_flags.shape[0]
    out_f = torch.empty((4, npad), dtype=torch.float32, device=dev)
    out_cnt = torch.empty(npad, dtype=torch.int32, device=dev)
    out_err = torch.empty(npad, dtype=torch.uint8, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_lane_aggregates(
            ptr(windows), ptr(lanes), ptr(tile_flags),
            ctypes.c_int64(npad), ctypes.c_int(cw), ctypes.c_int(D.barrel_mask(cw)),
            ctypes.c_int(k), ctypes.c_int64(tile_lanes),
            ptr(out_f), ptr(out_cnt), ptr(out_err), ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise launch_error("lane_aggregates", rc, windows=windows, lanes=lanes,
                           tile_flags=tile_flags, out_f=out_f, out_cnt=out_cnt, out_err=out_err)
    LAUNCHES += 1
    return LaneAggregates(
        sum=out_f[0, :n], count=out_cnt[:n], min=out_f[1, :n], max=out_f[2, :n],
        last=out_f[3, :n], err=out_err[:n].view(torch.bool),
    )


# ---------------------------------------------------------------------------
# Plain PyTorch twin (CPU tests; compared with the kernel on the card)
# ---------------------------------------------------------------------------

# lanes per block of the twin: bounds its temporaries at full size
_TWIN_BLOCK_LANES = 1 << 20


def _min_nan(a, b):
    """jnp.minimum: NaN if either is NaN; of equal values the one with the
    sign bit (min(+0, -0) = -0 in either order)."""
    tie = (a.view(torch.int32) | b.view(torch.int32)).view(torch.float32)
    m = torch.where(a < b, a, torch.where(b < a, b, tie))
    return torch.where(torch.isnan(a) | torch.isnan(b), torch.nan, m)


def _max_nan(a, b):
    tie = (a.view(torch.int32) & b.view(torch.int32)).view(torch.float32)
    m = torch.where(a > b, a, torch.where(b > a, b, tie))
    return torch.where(torch.isnan(a) | torch.isnan(b), torch.nan, m)


class _Acc:
    """The five running aggregates of a set of lanes."""

    def __init__(self, like):
        f = torch.float32
        self.sum = torch.zeros(like.shape, dtype=f, device=like.device)
        self.count = torch.zeros(like.shape, dtype=torch.int32, device=like.device)
        self.min = torch.full(like.shape, torch.inf, dtype=f, device=like.device)
        self.max = torch.full(like.shape, -torch.inf, dtype=f, device=like.device)
        self.last = torch.full(like.shape, torch.nan, dtype=f, device=like.device)

    def fold(self, valid, v):
        self.sum = D._ftz(self.sum + torch.where(valid, v, 0.0))
        self.count = self.count + valid.to(torch.int32)
        self.min = _min_nan(self.min, torch.where(valid, v, torch.inf))
        self.max = _max_nan(self.max, torch.where(valid, v, -torch.inf))
        self.last = torch.where(valid, v, self.last)


def walk_general(fetch, ln, k):
    """The general body's record walk (fused.py _run_lane_tile with
    int_optimized, chunked.py decode_chunked_lanes' step): yields
    (valid, state) after each of the k records; the last state's err is the
    lanes' err flag."""
    rel = D.as_i32(ln["rel_pos"])
    num_bits = D.as_i32(ln["num_bits"])
    zero = torch.zeros_like(rel)
    state = D.DecodeState(
        pos=zero,
        done=num_bits <= rel,
        err=torch.zeros_like(rel, dtype=torch.bool),
        prev_time=(ln["prev_time_hi"], ln["prev_time_lo"]),
        prev_delta=(ln["prev_delta_hi"], ln["prev_delta_lo"]),
        time_unit=D.as_i32(ln["time_unit"]),
        prev_float_bits=(ln["prev_float_bits_hi"], ln["prev_float_bits_lo"]),
        prev_xor=(ln["prev_xor_hi"], ln["prev_xor_lo"]),
        int_val=(ln["int_val_hi"], ln["int_val_lo"]),
        mult=D.as_i32(ln["mult"]),
        sig=D.as_i32(ln["sig"]),
        is_float=ln["is_float"] != 0,
    )
    first_chunk = ln["first"] != 0
    never = torch.zeros_like(first_chunk)
    nb = num_bits - rel
    nt = D._extract(fetch(zero), 0, 64)
    for idx in range(k):
        first = first_chunk if idx == 0 else never
        was_active = ~state.done & ~state.err
        state = D._decode_timestamp(fetch, nb, state, first, nt)
        ts_active = ~state.done & ~state.err
        state = D._decode_value(fetch, state, first)
        yield was_active & ts_active & ~state.done & ~state.err, state


def _run_general(fetch, ln, k, acc):
    """General body (fused.py _run_lane_tile, int_optimized)."""
    state = None
    for valid, state in walk_general(fetch, ln, k):
        v = torch.where(
            state.is_float,
            D.f64_bits_to_f32(state.prev_float_bits),
            D._int_val_to_f32(state.int_val, state.mult),
        )
        acc.fold(valid, v)
    return state.err


def _run_fast_int(fetch, ln, k, acc):
    """Int-fast body (fused.py _run_lane_tile_fast)."""
    rel = D.as_i32(ln["rel_pos"])
    active = D.as_i32(ln["num_bits"]) > rel
    pos = torch.zeros_like(rel)
    iv = D.as_i32(ln["int_val_lo"])
    sig, mult = D.as_i32(ln["sig"]), D.as_i32(ln["mult"])
    for _ in range(k):
        pos = pos + D._ts_consumed_fast(fetch(pos))
        pos, iv, sig, mult = D._decode_value_fast(fetch, pos, iv, sig, mult)
        acc.fold(active, D._int32_val_to_f32(iv, mult))
    return torch.zeros_like(active)


def _run_fast_float(fetch, ln, k, acc):
    """Float-fast body (fused.py _run_lane_tile_fast_float)."""
    rel = D.as_i32(ln["rel_pos"])
    active = D.as_i32(ln["num_bits"]) > rel
    pos = torch.zeros_like(rel)
    pfb = (ln["prev_float_bits_hi"], ln["prev_float_bits_lo"])
    pxr = (ln["prev_xor_hi"], ln["prev_xor_lo"])
    for _ in range(k):
        pos = pos + D._ts_consumed_fast(fetch(pos))
        ws = fetch(pos)
        repeat = D._extract32(ws, 0, 1) == 0
        nb, nx, consumed = D._read_xor(ws, 1, pfb, pxr)
        pfb = D.pair_select(repeat, pfb, nb)
        pxr = D.pair_select(repeat, pxr, nx)
        pos = pos + torch.where(repeat, 2, 1 + consumed)
        acc.fold(active, D.f64_bits_to_f32(pfb))
    return torch.zeros_like(active)


_BODIES = {0: _run_general, 1: _run_fast_int, 2: _run_fast_float}


def _row_fetch(rows, rel):
    """fetch(pos) over lane-major window rows int32 [n, CW]."""
    cw = rows.shape[1]
    mask = D.barrel_mask(cw)
    win_ext = torch.zeros((rows.shape[0], mask + 4), dtype=torch.int64, device=rows.device)
    win_ext[:, :cw] = rows.to(torch.int64) & D.M32
    rel = D.as_i32(rel)
    return lambda pos: D.fetch4(win_ext, mask, rel, pos)


def lane_inputs(windows, lanes, idx):
    """(fetch, planes by name) of the lanes ``idx`` (an index tensor or a
    slice) in the twin's word convention."""
    planes = lanes[:, idx].to(torch.int64) & D.M32
    ln = {name: planes[i] for i, name in enumerate(PACKED_LANE_PLANES)}
    return _row_fetch(windows[:, idx].T, ln["rel_pos"]), ln


def lane_aggregates_reference(windows, lanes, tile_flags, n: int, k: int) -> LaneAggregates:
    """Plain PyTorch version of the kernel, on any device. Lanes are decoded
    in blocks of whole tiles; within a block each body runs on the lanes of
    the tiles whose flag selects it."""
    _check_inputs(windows, lanes, tile_flags, n, k)
    npad = windows.shape[1]
    dev = windows.device
    tile_lanes = npad // tile_flags.shape[0]
    block = max(tile_lanes, _TWIN_BLOCK_LANES // tile_lanes * tile_lanes)

    out = _Acc(torch.empty(npad, device=dev))
    out_err = torch.zeros(npad, dtype=torch.bool, device=dev)
    for start in range(0, npad, block):
        stop = min(start + block, npad)
        lane = torch.arange(start, stop, device=dev)
        lane_flag = tile_flags[lane // tile_lanes]
        for cls, body in _BODIES.items():
            idx = lane[lane_flag == cls]
            if idx.numel() == 0:
                continue
            fetch, ln = lane_inputs(windows, lanes, idx)
            acc = _Acc(ln["rel_pos"])
            err = body(fetch, ln, k, acc)
            for name in ("sum", "count", "min", "max", "last"):
                getattr(out, name)[idx] = getattr(acc, name)
            out_err[idx] = err
    return LaneAggregates(
        sum=out.sum[:n], count=out.count[:n], min=out.min[:n], max=out.max[:n],
        last=out.last[:n], err=out_err[:n],
    )


# ---------------------------------------------------------------------------
# B3: the per-field layout (m3_tpu/ops/fused.py:704 lane_aggregates_pallas)
# ---------------------------------------------------------------------------

# Launches of B3, counted by lane_aggregates_fields where it launches.
FIELDS_LAUNCHES = 0

_PAIR_FIELDS = ("prev_time", "prev_delta", "prev_float_bits", "prev_xor", "int_val")
_BOOL_FIELDS = ("first", "is_float")


def _field_planes(windows, fields: dict, k: int) -> list:
    """Check B3's inputs; returns the 17 field arrays in
    PACKED_LANE_PLANES order (pairs split into their hi and lo words)."""
    if not isinstance(windows, torch.Tensor) or windows.dtype != torch.int32 or windows.dim() != 2:
        raise TypeError("windows must be an int32 [N, CW] tensor of u32 bit patterns")
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    n = windows.shape[0]
    planes = []
    for name in PACKED_LANE_PLANES:
        base = name[:-3] if name.endswith(("_hi", "_lo")) else name
        x = fields[base]
        if base in _PAIR_FIELDS:
            x = x[0] if name.endswith("_hi") else x[1]
        want = torch.bool if base in _BOOL_FIELDS else torch.int32
        if not isinstance(x, torch.Tensor) or x.dtype != want or tuple(x.shape) != (n,):
            raise TypeError(f"{name} must be a {want} tensor of shape [{n}]")
        if x.device != windows.device:
            raise ValueError(f"{name} and windows lie on different devices")
        planes.append(x)
    return planes


def lane_aggregates_fields(windows, rel_pos, num_bits, first, prev_time, prev_delta,
                           prev_float_bits, prev_xor, int_val, time_unit, sig, mult, is_float,
                           k: int) -> LaneAggregates:
    """B3: decode k records per lane with the general body and fold them
    into per-lane aggregates, over the per-field layout
    (``ops/chunked.lane_kwargs`` names): windows int32 [N, CW] lane-major,
    int32 fields of u32 bit patterns, (hi, lo) pairs for the 64-bit
    carries, bool ``first``/``is_float``.

    For CUDA tensors this launches the kernel (``csrc/lane_aggregates.cu``
    m3_lane_aggregates_fields) and raises if the build or the launch
    fails; for CPU tensors it runs the plain twin."""
    planes = _field_planes(windows, dict(
        rel_pos=rel_pos, num_bits=num_bits, first=first, prev_time=prev_time,
        prev_delta=prev_delta, prev_float_bits=prev_float_bits, prev_xor=prev_xor,
        int_val=int_val, time_unit=time_unit, sig=sig, mult=mult, is_float=is_float), k)
    if windows.device.type == "cpu":
        return _fields_reference(windows, planes, k)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    return _launch_fields(windows, planes, k)


def _launch_fields(windows, planes, k) -> LaneAggregates:
    global FIELDS_LAUNCHES
    from ._build import load_library

    lib = load_library("lane_aggregates")
    check_launch_shape(lib, "lane_aggregates_fields", windows.shape[1])
    windows = windows.contiguous()  # 4-byte copies: any offset will do
    planes = [p.contiguous() for p in planes]
    n, cw = windows.shape
    dev = windows.device
    out_f = torch.empty((4, n), dtype=torch.float32, device=dev)
    out_cnt = torch.empty(n, dtype=torch.int32, device=dev)
    out_err = torch.empty(n, dtype=torch.uint8, device=dev)
    fields = (ctypes.c_void_p * NLANE)(*[p.data_ptr() for p in planes])
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_lane_aggregates_fields(
            ptr(windows), fields, ctypes.c_int64(n), ctypes.c_int(cw),
            ctypes.c_int(D.barrel_mask(cw)), ctypes.c_int(k),
            ptr(out_f), ptr(out_cnt), ptr(out_err), ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"lane_aggregates_fields kernel launch failed: CUDA error {rc}")
    FIELDS_LAUNCHES += 1
    return LaneAggregates(
        sum=out_f[0], count=out_cnt, min=out_f[1], max=out_f[2], last=out_f[3],
        err=out_err.view(torch.bool),
    )


def lane_aggregates_fields_reference(windows, rel_pos, num_bits, first, prev_time, prev_delta,
                                     prev_float_bits, prev_xor, int_val, time_unit, sig, mult,
                                     is_float, k: int) -> LaneAggregates:
    """Plain PyTorch version of B3, on any device: the general body
    (``_run_general``) on every lane, in blocks of lanes."""
    planes = _field_planes(windows, dict(
        rel_pos=rel_pos, num_bits=num_bits, first=first, prev_time=prev_time,
        prev_delta=prev_delta, prev_float_bits=prev_float_bits, prev_xor=prev_xor,
        int_val=int_val, time_unit=time_unit, sig=sig, mult=mult, is_float=is_float), k)
    return _fields_reference(windows, planes, k)


def _fields_reference(windows, planes, k) -> LaneAggregates:
    n = windows.shape[0]
    dev = windows.device
    out = _Acc(torch.empty(n, device=dev))
    out_err = torch.zeros(n, dtype=torch.bool, device=dev)
    for start in range(0, n, _TWIN_BLOCK_LANES):
        rows = slice(start, min(start + _TWIN_BLOCK_LANES, n))
        ln = {name: p[rows].to(torch.int64) & D.M32 for name, p in zip(PACKED_LANE_PLANES, planes)}
        acc = _Acc(ln["rel_pos"])
        out_err[rows] = _run_general(_row_fetch(windows[rows], ln["rel_pos"]), ln, k, acc)
        for name in ("sum", "count", "min", "max", "last"):
            getattr(out, name)[rows] = getattr(acc, name)
    return LaneAggregates(sum=out.sum, count=out.count, min=out.min, max=out.max,
                          last=out.last, err=out_err)
