"""Build and load the port's native libraries (shared libraries with a plain
C interface, loaded with ctypes): the CUDA kernels, compiled by nvcc, and
the host codec library (``native/m3tsz.cc``), compiled by g++.

Each source in ``SOURCES`` (nvcc) and ``HOST_SOURCES`` (g++) becomes its
own library, compiled at first use into ``build/kernels/`` at the root of
the checkout (listed in .gitignore) and named by a hash of the source and
its flags, so an edited source is rebuilt (the headers in ``HEADERS``,
which the CUDA sources include, are part of their hashes). ``build_all``
starts one compiler per source at once and waits for all of them. The host
library builds without nvcc, on the CPU too. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG.parent / "build" / "kernels"

_COMMON = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# headers the sources include (by a path relative to each source)
HEADERS = (PKG / "csrc" / "launch.cuh",)

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_I32 = ctypes.c_int32

# library -> (source, nvcc flags, {entry: argtypes}). The flags are part of
# each kernel's contract with the reference's f32 arithmetic (see the note at
# the top of each source): -fmad=false everywhere; -ftz=true for the lane
# decode, the grouped reductions and the rollup reductions, whose reference
# flushes f32 subnormals as XLA does, and for the consolidation (its f64
# arithmetic is unaffected).
SOURCES = {
    "lane_aggregates": (
        PKG / "ops" / "csrc" / "lane_aggregates.cu",
        _COMMON + ("-ftz=true",),
        {
            # windows, lanes, flags, npad, cw, mask, k, tile_lanes,
            # out_f, out_cnt, out_err, stream
            "m3_lane_aggregates": [_P, _P, _P, _I64, _I, _I, _I, _I64, _P, _P, _P, _P],
            # windows, lanes, npad, n, cw, mask, k,
            # out_ts, out_bits, out_pif, out_mult, out_valid, out_err, stream
            "m3_decode_records": [_P, _P, _I64, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
            # words, num_bits, initial_unit, s, w, t, int_optimized, out_ts,
            # out_bits, out_pif, out_mult, out_valid, out_err, out_f32, stream
            "m3_decode_batched": [_P, _P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                  _P],
            # s, out int64[9]: warps a block, blocks, resident blocks, shared
            # memory a block, registers, local memory, group, flag group, ring words
            "m3_decode_batched_shape": [_I64, _P],
            # windows, fields (host array of 17 pointers), n, cw, mask, k,
            # out_f, out_cnt, out_err, stream
            "m3_lane_aggregates_fields": [_P, _P, _I64, _I, _I, _I, _P, _P, _P, _P],
            # which (0 B1, 1 R, 2 B3), cw, mask, out int64* blocks, out int* registers
            "m3_lane_resident_blocks": [_I, _I, _I, _P, _P],
            # which, cw, mask -> bytes of shared memory a block needs (int64)
            "m3_lane_smem_bytes": [_I, _I, _I],
            # -> the most shared memory a block may use (int64)
            "m3_lane_smem_max_bytes": [],
        },
    ),
    "temporal_fused": (
        PKG / "query" / "functions" / "csrc" / "temporal_fused.cu",
        _COMMON,
        {
            # x, rows, cols, window, step_seconds, outs, fns, nfn,
            # scratch, scratch_bytes, stream
            "m3_temporal_fused": [_P, _I64, _I, _I, ctypes.c_double, _P, _P, _I, _P, _I64, _P],
            # rows, cols, window, fns, nfn -> bytes of device scratch (int64)
            "m3_temporal_fused_scratch_bytes": [_I64, _I, _I, _P, _I],
        },
    ),
    "temporal_window": (
        PKG / "query" / "functions" / "csrc" / "temporal_window.cu",
        _COMMON,
        {
            # x, rows, cols, window, first, fn, a, b, c, d, run, force_global,
            # out, scratch, scratch_bytes, stream
            "m3_temporal_window": [_P, _I64, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _P, _P, _I64,
                                   _P],
            # rows, cols, window, first, fn, run, force_global -> bytes of device
            # scratch (int64)
            "m3_temporal_window_scratch_bytes": [_I64, _I, _I, _I, _I, _I, _I],
            # rows, cols, window, first, fn, run, force_global, out int64[9]:
            # threads, run, staged, shared memory a block, blocks, scratch bytes,
            # rows a warp, lanes a row, tables
            "m3_temporal_window_shape": [_I64, _I, _I, _I, _I, _I, _I, _P],
        },
    ),
    "index_kernels": (
        PKG / "index" / "device" / "csrc" / "index_kernels.cu",
        _COMMON,
        {
            # keys, lens, n_terms, k_words, lo, hi, q_keys, q_lens, rows, out, stream
            "m3_index_match_terms": [_P, _P, _I64, _I, _P, _P, _P, _P, _I64, _P, _P],
            # post_data, n_post, spans (host), n_spans, shift, threads, scratch,
            # words, n_rows, n_words, stream
            "m3_index_bitmap_spans": [_P, _I64, _P, _I64, _I, _I, _P, _P, _I64, _I64, _P],
            # stream: an empty kernel (the launch floor)
            "m3_launch_floor": [_P],
        },
    ),
    "grouped_reduce": (
        PKG / "query" / "functions" / "csrc" / "grouped_reduce.cu",
        _COMMON + ("-ftz=true",),
        {
            # values, rows, cols, pad_index, groups, m, op, wc, out, stream
            "m3_grouped_reduce": [_P, _I64, _I64, _P, _I64, _I64, _I, _I, _P, _P],
            # groups, cols -> the column-block width the entry picks
            "m3_grouped_reduce_width": [_I64, _I64],
        },
    ),
    "resident_assembly": (
        PKG / "parallel" / "csrc" / "resident_assembly.cu",
        _COMMON,
        {
            # words, side, page_rows, side_rows, n_chunks, total_bits, block_hi,
            # block_lo, s, c, lp, sl, w, spc, cw, order, lane_major, npad,
            # tile_lanes, slot_words, windows, planes, tile_flags, stream
            "m3_resident_assembly": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I,
                                     _I, _I, _I, _I, _I64, _I64, _I, _P, _P, _P, _P],
            # c, cw -> the most stream words a staged series may take
            "m3_resident_assembly_slot_words": [_I64, _I],
        },
    ),
    "consolidate_grid": (
        PKG / "query" / "csrc" / "consolidate_grid.cu",
        _COMMON + ("-ftz=true",),
        {
            # ts, bits, point_is_float, mult, valid, s, p, lo, hi, grid, t,
            # lookback, out values, out counts, tile, run, stream
            "m3_consolidate_grid": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _I64, _I64,
                                    _P, _P, _I, _I, _P],
            # s, p, t, tile, run, out int64[8]: warps a block, resident
            # blocks, shared memory a block, registers, grid in shared
            # memory, tile, run, blocks launched
            "m3_consolidate_grid_shape": [_I64, _I64, _I64, _I, _I, _P],
            # -> the most records a warp stages at once
            "m3_consolidate_grid_tile_records": [],
        },
    ),
    "rollup": (
        PKG / "aggregator" / "csrc" / "rollup.cu",
        _COMMON + ("-ftz=true",),
        {
            # vals, torder, valid, g, p, out, stream
            "m3_aggregate_dense": [_P, _P, _P, _I64, _I64, _P, _P],
            # vals, valid, g, p, qs (host f32 array), nq, scratch (the long
            # rows' work list, int64 [g + 1]), out, stream
            "m3_dense_quantiles": [_P, _P, _I64, _I64, _P, _I, _P, _P, _P],
        },
    ),
    "encode": (
        PKG / "ops" / "csrc" / "encode.cu",
        _COMMON,
        {
            # t0, counts, float_lane, dod, vbits, m, t, k, w, c, out words,
            # out total_bits, out chunk_offs, out chunk_sigs, stream
            "m3_encode_lanes": [_P, _P, _P, _P, _P, _I64, _I64, _I, _I64, _I64, _P, _P, _P, _P,
                                _P],
            # m, out int64[6]: warps a block, blocks, resident blocks,
            # shared memory, registers, local memory
            "m3_encode_shape": [_I64, _P],
        },
    ),
}

# library -> (source, g++ flags, {entry: (restype, argtypes)}). No
# -march=native: a library named by a hash of its source and flags may be
# loaded on another host than the one that built it. -ffp-contract=off: no
# multiply and add fused into one rounding, so that the library's float
# arithmetic is the Python codec's, operation by operation.
HOST_SOURCES = {
    "m3tsz": (
        PKG / "native" / "m3tsz.cc",
        ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", "-lpthread"),
        {
            # times, values, n, default_unit, units (or NULL), int_optimized,
            # out, out_cap -> bytes, -(needed) or -1
            "m3tsz_encode_series": (_I64, [_P, _P, _I32, _I, _P, _I, _P, _I64]),
            # times, values, lengths, n_series, default_unit, int_optimized,
            # out, out_cap, out_offsets, n_threads -> bytes, -(needed) or -1
            "m3tsz_encode_batch": (_I64, [_P, _P, _P, _I32, _I, _I, _P, _I64, _P, _I32]),
            # data, len_bytes, k, default_unit, int_optimized, snaps (49-byte
            # records), max_snaps -> the snapshot count
            "m3tsz_prescan": (_I32, [_P, _I64, _I32, _I, _I, _P, _I32]),
            # data, offsets, n_series, k, default_unit, int_optimized, snaps,
            # max_snaps_per, snap_counts, n_threads
            "m3tsz_prescan_batch": (_I32, [_P, _P, _I32, _I32, _I, _I, _P, _I32, _P, _I32]),
            # data, offsets, n_series, default_unit, int_optimized, cap,
            # out_times, out_values, out_units, out_counts, out_flags,
            # n_threads -> the number of streams that failed
            "m3tsz_decode_batch": (_I32, [_P, _P, _I32, _I, _I, _I64, _P, _P, _P, _P, _P, _I32]),
            # ids, times, n, window0, resolution, n_windows, out_keys,
            # out_torder, n_threads -> 0 or -1 (a key past INT32_MAX)
            "m3agg_window_keys": (_I32, [_P, _P, _I64, _I64, _I64, _I32, _P, _P, _I32]),
            # keys, n, n_groups, counts, n_threads -> the largest count or -1
            "m3agg_count": (_I32, [_P, _I64, _I64, _P, _I32]),
            # keys, values, torder, n, n_groups, p, counts, out_vals, out_tor,
            # n_threads
            "m3agg_pack": (None, [_P, _P, _P, _I64, _I64, _I32, _P, _P, _P, _I32]),
            # ids, offsets, n, num_shards, out
            "m3hash_shards": (None, [_P, _P, _I32, _I32, _P]),
        },
    ),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # the compiler's output (ptxas's register/spill report) per library


def launch_error(kernel: str, rc: int, **tensors) -> RuntimeError:
    """The error a wrapper raises when its kernel's launch failed: the CUDA
    error code and each launch tensor's shape, stride, dtype and data
    pointer, so that one log line shows what the kernel was given."""
    given = "; ".join(
        f"{name} shape {tuple(t.shape)} stride {tuple(t.stride())} {t.dtype} at 0x{t.data_ptr():x}"
        for name, t in tensors.items() if t is not None)
    return RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}; {given}")


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def gxx_path() -> str:
    cand = shutil.which("g++") or shutil.which("c++")
    if cand is None:
        raise RuntimeError("g++ not found: the host codec library cannot be built")
    return cand


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        source, flags, _ = HOST_SOURCES[name]
        text = source.read_bytes()
    else:
        source, flags, _ = SOURCES[name]
        text = source.read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every library in ``names`` (default: all, the host codec
    library too) that is not built yet, one compiler process per source (nvcc
    for ``SOURCES``, g++ for ``HOST_SOURCES``), all started together.
    Returns the library paths; raises if any build fails."""
    names = [*SOURCES, *HOST_SOURCES] if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if name in HOST_SOURCES:
            source, flags, _ = HOST_SOURCES[name]
            # the source before the flags: -lpthread must follow it
            cmd = [gxx_path(), str(source), *flags, "-o", str(tmp)]
        else:
            source, flags, _ = SOURCES[name]
            cmd = [nvcc_path(), *flags, "-o", str(tmp), str(source)]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out, cmd[0])
    failed = []
    for name, (proc, tmp, out, compiler) in running.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: {os.path.basename(compiler)} failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first call), with the ctypes
    signatures of its entries set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            if name in HOST_SOURCES:
                for entry, (restype, argtypes) in HOST_SOURCES[name][2].items():
                    fn = getattr(lib, entry)
                    fn.argtypes, fn.restype = argtypes, restype
            else:
                for entry, argtypes in SOURCES[name][2].items():
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = _I64 if entry.endswith("_bytes") else ctypes.c_int
            _libs[name] = lib
        return lib
