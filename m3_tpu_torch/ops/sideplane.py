"""Packed per-chunk side-plane layout: 10 uint32 words per chunk.

Port of ``m3_tpu/ops/sideplane.py``. One chunk's decoder-state snapshot
(``ops/chunked.snapshot_stream``) packs into 10 words: the five 64-bit
carries take their 10 halves minus what two shared words hold. The host
packers are copies; ``unpack_side_planes`` is the device unpack in torch.

Layout (word index -> contents, bit ranges high:low):

====  =======================================================
w0-1  ``prev_float_bits`` hi, lo
w2-3  ``prev_xor`` hi, lo
w4-5  ``int_val`` hi, lo
w6    ``rel_prev_time`` bits 31:0  (prev_time - block_start)
w7    ``prev_delta`` bits 31:0
w8    ``off``[31:11] | ``time_unit``[10:8] | ``sig``[7:2] | ``flags``[1:0]
w9    ``rel_prev_time`` bits 43:32 [31:20] | ``prev_delta`` bits
      44:32 [19:7] | ``pt_zero``[6] | ``mult``[5:1] | ``is_float``[0]
====  =======================================================

``pt_zero`` marks the first chunk's pristine carry (``prev_time == 0``,
which block-relative storage cannot express); ``flags`` holds the
fast-chunk classification (1 = int-fast, 2 = float-fast). A snapshot any
field of which overflows the packed ranges has no packed form: the packers
return None and the lane is admitted without side planes. All-zero rows
(the reserved zero side page, padding lanes) unpack to the all-zero
decoder state of the host packer's padding lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import decode as D

SIDE_WORDS = 10

# packed field capacities (exclusive upper bounds)
OFF_BITS = 21
RT_BITS = 44  # block-relative prev_time
PD_BITS = 45  # prev_delta
TU_BITS, SIG_BITS, MULT_BITS = 3, 6, 5

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def pack_side_row(p: dict, block_start: int):
    """One snapshot dict -> tuple of 10 uint32 words, or None when any
    field overflows the packed ranges."""
    off = int(p["off"])
    tu = int(p["time_unit"])
    sig = int(p["sig"])
    mult = int(p["mult"])
    pt = int(p["prev_time"]) & _M64
    pd = int(p["prev_delta"]) & _M64
    if (
        off >= 1 << OFF_BITS
        or tu >= 1 << TU_BITS
        or sig >= 1 << SIG_BITS
        or mult >= 1 << MULT_BITS
        or pd >= 1 << PD_BITS
    ):
        return None
    if pt == 0:
        rel, ptz = 0, 1
    else:
        rel = pt - (int(block_start) & _M64)
        ptz = 0
        if rel < 0 or rel >= 1 << RT_BITS:
            return None
    pfb = int(p["prev_float_bits"]) & _M64
    pxr = int(p["prev_xor"]) & _M64
    iv = int(p["int_val"]) & _M64
    flags = (1 if p.get("fast") else 0) | (2 if p.get("fast_float") else 0)
    w8 = (off << 11) | (tu << 8) | (sig << 2) | flags
    w9 = ((rel >> 32) << 20) | ((pd >> 32) << 7) | (ptz << 6) | (mult << 1) | int(bool(p["is_float"]))
    return (
        pfb >> 32, pfb & _M32,
        pxr >> 32, pxr & _M32,
        iv >> 32, iv & _M32,
        rel & _M32,
        pd & _M32,
        w8, w9,
    )


def pack_side_rows(snaps: list, block_start: int) -> np.ndarray | None:
    """Snapshot dicts -> uint32[n_chunks, SIDE_WORDS], or None when ANY
    chunk overflows (side planes are all-or-nothing per lane)."""
    rows = np.zeros((len(snaps), SIDE_WORDS), np.uint32)
    for j, p in enumerate(snaps):
        packed = pack_side_row(p, block_start)
        if packed is None:
            return None
        rows[j] = packed
    return rows


def pack_side_rows_vec(
    off, prev_time, prev_delta, time_unit, prev_float_bits, prev_xor, int_val,
    sig, mult, is_float, fast, fast_float, block_start: int,
) -> np.ndarray | None:
    """Vectorized :func:`pack_side_rows`: per-chunk field arrays (64-bit
    fields as uint64) -> uint32[n_chunks, SIDE_WORDS], or None when any
    chunk overflows; bit-identical to the dict packer for every row it
    accepts."""
    off = np.asarray(off, np.uint64)
    pt = np.asarray(prev_time, np.uint64)
    pd = np.asarray(prev_delta, np.uint64)
    tu = np.asarray(time_unit, np.uint64)
    sig = np.asarray(sig, np.uint64)
    mult = np.asarray(mult, np.uint64)
    pfb = np.asarray(prev_float_bits, np.uint64)
    pxr = np.asarray(prev_xor, np.uint64)
    iv = np.asarray(int_val, np.uint64)
    if (
        (off >= 1 << OFF_BITS).any()
        or (tu >= 1 << TU_BITS).any()
        or (sig >= 1 << SIG_BITS).any()
        or (mult >= 1 << MULT_BITS).any()
        or (pd >= 1 << PD_BITS).any()
    ):
        return None
    ptz = pt == 0
    # uint64 wraparound turns a prev_time below block_start into a huge
    # rel, caught by the same range check as the dict packer's rel < 0
    rel = np.where(ptz, np.uint64(0), pt - np.uint64(int(block_start) & _M64))
    if (rel >= 1 << RT_BITS).any():
        return None
    flags = np.where(np.asarray(fast, bool), np.uint64(1), np.uint64(0)) | np.where(
        np.asarray(fast_float, bool), np.uint64(2), np.uint64(0)
    )
    w8 = (off << np.uint64(11)) | (tu << np.uint64(8)) | (sig << np.uint64(2)) | flags
    w9 = (
        ((rel >> np.uint64(32)) << np.uint64(20))
        | ((pd >> np.uint64(32)) << np.uint64(7))
        | (np.where(ptz, np.uint64(1), np.uint64(0)) << np.uint64(6))
        | (mult << np.uint64(1))
        | np.where(np.asarray(is_float, bool), np.uint64(1), np.uint64(0))
    )
    rows = np.empty((off.shape[0], SIDE_WORDS), np.uint32)
    s32 = np.uint64(32)
    m32 = np.uint64(_M32)
    for j, col in enumerate(
        (pfb >> s32, pfb & m32, pxr >> s32, pxr & m32, iv >> s32, iv & m32,
         rel & m32, pd & m32, w8, w9)
    ):
        rows[:, j] = col.astype(np.uint32)
    return rows


def unpack_side_rows(rows: np.ndarray, block_start: int) -> list[dict]:
    """Host inverse of :func:`pack_side_rows`: packed rows -> snapshot
    dicts, bit-exact for every row the packer accepted (without
    ``span``/``total_bits``, which the caller adds)."""
    rows = np.asarray(rows, np.uint64)
    out = []
    for r in rows:
        w8 = int(r[8])
        w9 = int(r[9])
        rel = ((w9 >> 20) << 32) | int(r[6])
        ptz = (w9 >> 6) & 1
        out.append(dict(
            off=w8 >> 11,
            prev_time=0 if ptz else (int(block_start) + rel) & _M64,
            prev_delta=(((w9 >> 7) & 0x1FFF) << 32) | int(r[7]),
            prev_float_bits=(int(r[0]) << 32) | int(r[1]),
            prev_xor=(int(r[2]) << 32) | int(r[3]),
            int_val=(int(r[4]) << 32) | int(r[5]),
            time_unit=(w8 >> 8) & 7,
            sig=(w8 >> 2) & 0x3F,
            mult=(w9 >> 1) & 0x1F,
            is_float=bool(w9 & 1),
            fast=bool(w8 & 1),
            fast_float=bool(w8 & 2),
        ))
    return out


def unpack_side_planes(side: torch.Tensor, block: tuple, valid: torch.Tensor) -> dict:
    """Device unpack: packed side rows -> the decoder-state lane planes
    (``ops/chunked.LANE_FIELDS`` names plus ``off``/``flags``).

    ``side`` [N, SIDE_WORDS] gathered rows (int32 or int64 holding u32
    bits); ``block`` the per-lane block_start as a (hi, lo) pair of u32
    words held in int64; ``valid`` bool[N]. Every plane is a u32 word held
    in int64 (64-bit fields as (hi, lo) pairs, ops/decode.py's convention);
    invalid lanes are zero in every plane, as the host packer's padding
    lanes are, whatever the zero-page gather or the base would give."""
    side = side.to(torch.int64) & D.M32
    zero = torch.zeros((), dtype=torch.int64, device=side.device)

    def gate(x):
        return torch.where(valid, x, zero)

    w8 = side[:, 8]
    w9 = side[:, 9]
    rel = (w9 >> 20, side[:, 6])
    ptz = ((w9 >> 6) & 1) != 0
    pt = D.pair_add(rel, block)
    pt = (torch.where(ptz, zero, pt[0]), torch.where(ptz, zero, pt[1]))
    return {
        "off": gate(w8 >> 11),
        "prev_time": (gate(pt[0]), gate(pt[1])),
        "prev_delta": (gate((w9 >> 7) & 0x1FFF), gate(side[:, 7])),
        "prev_float_bits": (gate(side[:, 0]), gate(side[:, 1])),
        "prev_xor": (gate(side[:, 2]), gate(side[:, 3])),
        "int_val": (gate(side[:, 4]), gate(side[:, 5])),
        "time_unit": gate((w8 >> 8) & 7),
        "sig": gate((w8 >> 2) & 0x3F),
        "mult": gate((w9 >> 1) & 0x1F),
        "is_float": gate(w9 & 1),
        "flags": gate(w8 & 3),
    }
