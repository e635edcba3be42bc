"""Kernels of the inverted index's device tier, and the host key helpers.

Port of ``m3_tpu/index/device/kernels.py``. A sealed segment's device tier
(segment.py builds the arrays, store.py owns their budget) answers a query
with two kernels, both in ``csrc/index_kernels.cu``:

- K1 ``match_terms``: one lower-bound search (a warp a row, 33 ways a
  round) over the sorted fixed-width term-key matrix for B query rows at
  once (the batched FST lookup); per-row [lo, hi) bounds let one launch mix
  fields and segments.
- K2 ``bitmap_from_spans``: the OR of listed postings spans as packed doc
  bitmap rows, one bit a doc (bit j of word w is doc 32w + j), set with
  atomicOr from those postings only; one launch serves every leaf of a
  query on a segment, a row a leaf. A term list is its terms' ``post_idx``
  rows (``term_spans``), a field or prefix range one run.

The bitwise AND/OR/ANDNOT over bitmaps are torch ops (segment.py). A
wrapper launches its kernel for a CUDA tensor and runs its plain PyTorch
twin (``*_reference``) only for a CPU tensor; a failed build or launch
raises. ``LAUNCHES`` counts the kernel launches, one per wrapper call that
launched.

Term ordering contract (shared with the host helpers below): a term is
keyed as its bytes zero-padded to a fixed width and viewed as big-endian
uint32 words, with the byte length as the tiebreak. (words, length)
compares exactly like raw bytes: padding only collides when one term is a
NUL-extension of the other, and the length tiebreak resolves precisely
that case the way bytes ordering does (shorter first).

Words and keys are held in int32 tensors (their u32 bit patterns): torch
has no ``~`` or ``<<`` for uint32 on the CPU. They become uint32 only at
the host boundary (``bitmap_to_docids``).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import device_guard
from ...ops._build import launch_error, load_library

# Launches of K1 and K2, counted by the wrappers where they launch.
LAUNCHES = {"match_terms": 0, "bitmap_from_spans": 0}

# K2's threads a block
_K2_THREADS = 256

# ---------- host-side key building / compare (shared definition) ----------


def key_width_words(max_term_len: int) -> int:
    """uint32 words per term key covering ``max_term_len`` bytes."""
    return max(-(-int(max_term_len) // 4), 1)


def build_term_keys(terms: list, k_words: int):
    """(uint32[n, k_words] big-endian-packed keys, int32[n] lengths) for a
    list of term byte strings, each at most ``4 * k_words`` bytes."""
    n = len(terms)
    width = 4 * k_words
    buf = bytearray(n * width)
    lens = np.zeros(n, np.int32)
    for i, t in enumerate(terms):
        buf[i * width : i * width + len(t)] = t
        lens[i] = len(t)
    keys = np.frombuffer(bytes(buf), ">u4").reshape(n, k_words).astype(np.uint32)
    return keys, lens


def build_query_keys(values: list, k_words: int):
    """Key rows for query-side values. Values LONGER than the segment's
    key width cannot exist in its dictionary: their row is zeroed and its
    length is -1, which K1 answers with -1, instead of truncating — a
    truncated compare could false-match."""
    width = 4 * k_words
    clipped = [v if len(v) <= width else b"" for v in values]
    keys, lens = build_term_keys(clipped, k_words)
    for i, v in enumerate(values):
        if len(v) > width:
            lens[i] = -1
    return keys, lens


def host_key_lt(a_key, a_len: int, b_key, b_len: int) -> bool:
    """The (words, length) compare, host side — must order exactly like
    ``bytes(a) < bytes(b)``."""
    neq = a_key != b_key
    if neq.any():
        i = int(np.argmax(neq))
        return int(a_key[i]) < int(b_key[i])
    return a_len < b_len


def host_lower_bound(keys, lens, lo: int, hi: int, q_key, q_len: int) -> int:
    """First index in [lo, hi) whose term is >= the query key — the
    host mirror of K1's search, used for literal-prefix range narrowing."""
    while lo < hi:
        mid = (lo + hi) // 2
        if host_key_lt(keys[mid], int(lens[mid]), q_key, q_len):
            lo = mid + 1
        else:
            hi = mid
    return lo


def bitmap_to_docids(words) -> np.ndarray:
    """Packed doc bitmap (a torch or numpy array of 32-bit words, on any
    device) -> ascending int32 doc ids on the host. Bit j of word w is doc
    ``32*w + j``; on a little-endian host the byte view + little bit order
    reads exactly that sequence."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.ascontiguousarray(words).view(np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.int32)


def all_docs_words(n_docs: int) -> np.ndarray:
    """Host-built all-docs bitmap (uint32) with the tail bits past n_docs
    zeroed (uploaded once per segment; negation ANDs against it so phantom
    tail docs can never appear)."""
    n_words = -(-n_docs // 32)
    bits = np.zeros(n_words * 32, np.uint8)
    bits[:n_docs] = 1
    return np.packbits(bits, bitorder="little").view(np.uint32).copy()


def zero_bitmap(n_words: int, device) -> torch.Tensor:
    return torch.zeros(n_words, dtype=torch.int32, device=device)


# ---------- K1: batched term lookup ----------


def match_terms(keys, lens, lo, hi, q_keys, q_lens) -> torch.Tensor:
    """For each query row b, the GLOBAL index of term ``q_keys[b]`` within
    the sorted range [lo[b], hi[b]) of the key matrix, or -1 (int32[B], on
    the keys' device).

    ``keys`` int32[n, K] (u32 bit patterns) and ``lens`` int32[n] are the
    segment's key matrix; ``lo``/``hi``/``q_lens`` int32[B] and ``q_keys``
    int32[B, K]; ``q_lens < 0`` marks an unmatchable row."""
    if keys.device.type == "cpu":
        return match_terms_reference(keys, lens, lo, hi, q_keys, q_lens)
    _check_cuda(keys, lens, lo, hi, q_keys, q_lens)
    n, k = keys.shape
    rows = q_keys.shape[0]
    if q_keys.shape[1] != k or not lo.shape == hi.shape == q_lens.shape == (rows,):
        raise ValueError("match_terms: query rows and key matrix disagree in shape")
    out = torch.empty(rows, dtype=torch.int32, device=keys.device)
    if rows == 0:
        return out
    lib = load_library("index_kernels")
    with device_guard(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = lib.m3_index_match_terms(
            keys.data_ptr(), lens.data_ptr(), n, k, lo.data_ptr(), hi.data_ptr(),
            q_keys.data_ptr(), q_lens.data_ptr(), rows, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"index match_terms kernel launch failed: CUDA error {rc}")
    LAUNCHES["match_terms"] += 1
    return out


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as their unsigned values (int64)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def match_terms_reference(keys, lens, lo, hi, q_keys, q_lens) -> torch.Tensor:
    """Plain PyTorch twin of K1: the reference's search, a fixed
    ``bit_length(n)`` iterations over every row at once."""
    n = keys.shape[0]
    rows = q_keys.shape[0]
    if n == 0 or rows == 0:
        return torch.full((rows,), -1, dtype=torch.int32, device=keys.device)
    kk, qk = _u32(keys), _u32(q_keys)
    lens, q_lens = lens.to(torch.int64), q_lens.to(torch.int64)
    bad = q_lens < 0
    lo_v = torch.where(bad, 0, lo.to(torch.int64).clamp(min=0))
    hi_v = torch.where(bad, 0, hi.to(torch.int64).clamp(max=n))
    end = hi_v
    for _ in range(max(int(n).bit_length(), 1)):
        active = lo_v < hi_v
        mid = (lo_v + hi_v) // 2
        midc = mid.clamp(0, n - 1)
        lt = _key_lt(kk[midc], lens[midc], qk, q_lens)
        lo_v = torch.where(active & lt, mid + 1, lo_v)
        hi_v = torch.where(active & ~lt, mid, hi_v)
    pos = lo_v.clamp(0, n - 1)
    eq = (kk[pos] == qk).all(dim=1) & (lens[pos] == q_lens)
    return torch.where((lo_v < end) & eq, lo_v, -1).to(torch.int32)


def _key_lt(ak, al, bk, bl):
    neq = ak != bk
    idx = neq.to(torch.int32).argmax(dim=1, keepdim=True)  # first unequal word
    aw = ak.gather(1, idx)[:, 0]
    bw = bk.gather(1, idx)[:, 0]
    return torch.where(neq.any(dim=1), aw < bw, al < bl)


# ---------- K2: postings union into packed bitmaps ----------


def term_spans(host_post_idx: np.ndarray, gis) -> np.ndarray:
    """The postings spans (int64 [m, 2]: start, end) of a list of global
    term indices (-1 entries, and indices past the dictionary, skipped)."""
    gis = np.asarray(gis, np.int64)
    hit = gis[(gis >= 0) & (gis < len(host_post_idx))]
    return np.asarray(host_post_idx, np.int64)[hit].reshape(-1, 2)


def bitmap_from_spans(post_data, spans, n_rows: int, n_words: int) -> torch.Tensor:
    """Packed doc bitmaps int32[n_rows, n_words] on the postings' device:
    row r is the OR of the postings ``post_data[start:end)`` of every span
    (``spans`` host int64 [m, 3]: row, start, end) of row r; empty spans
    and duplicates are harmless. One launch: the entry lays the spans out
    and hands them to the kernel in one copy into scratch allocated past
    the words."""
    spans = np.ascontiguousarray(spans, np.int64).reshape(-1, 3)
    if n_rows * n_words > 0x7FFFFFFF:
        raise ValueError("bitmap_from_spans: the bitmap rows exceed 2**31 words")
    if post_data.device.type == "cpu":
        if len(spans) and (spans[:, 0].min() < 0 or spans[:, 0].max() >= n_rows
                           or spans[:, 1].min() < 0 or spans[:, 2].max() > len(post_data)):
            raise ValueError(_OUTSIDE)
        return bitmap_from_spans_reference(post_data, spans, n_rows, n_words)
    _check_cuda(post_data)
    # the rows, then room for the laid-out spans (4m + 1 int64) from the
    # next 16-byte boundary
    extra = -(-(8 * (4 * len(spans) + 1) + 16) // (4 * max(n_words, 1)))
    words = torch.empty((n_rows + extra, n_words or 1), dtype=torch.int32,
                        device=post_data.device)
    base = words.data_ptr()
    scratch = -(-(base + 4 * n_rows * n_words) // 16) * 16
    lib = load_library("index_kernels")
    with device_guard(post_data.device):
        stream = torch.cuda.current_stream(post_data.device).cuda_stream
        rc = lib.m3_index_bitmap_spans(
            post_data.data_ptr(), len(post_data), spans.ctypes.data, len(spans),
            (post_data.data_ptr() >> 2) & 3, _K2_THREADS, scratch, base, n_rows, n_words, stream,
        )
    if rc == -2:
        raise ValueError(_OUTSIDE)
    words = words[:n_rows, :n_words]
    if rc == -1:  # no span holds a posting: zeroed, nothing launched
        return words
    if rc != 0:
        raise launch_error("index bitmap_from_spans", rc, post_data=post_data, words=words)
    LAUNCHES["bitmap_from_spans"] += 1
    return words


_OUTSIDE = "bitmap_from_spans: a span lies outside its rows or the postings"


def bitmap_from_spans_reference(post_data, spans, n_rows: int, n_words: int) -> torch.Tensor:
    """Plain PyTorch twin of K2: each row packed from its spans' postings."""
    spans = np.asarray(spans, np.int64).reshape(-1, 3)
    out = torch.zeros((n_rows, n_words), dtype=torch.int32, device=post_data.device)
    for r in range(n_rows):
        mine = spans[spans[:, 0] == r]
        pos = [np.arange(a, b) for a, b in mine[:, 1:] if b > a]
        if pos:
            idx = torch.from_numpy(np.concatenate(pos)).to(post_data.device)
            out[r] = _pack_docs(post_data[idx], n_words)
    return out


def bitmap_from_terms_reference(post_idx, post_data, gis, n_words: int) -> torch.Tensor:
    """Plain PyTorch twin of K2's term-list form."""
    gis = gis.to(torch.int64)
    gis = gis[(gis >= 0) & (gis < post_idx.shape[0])]
    starts = post_idx[gis, 0].to(torch.int64)
    counts = post_idx[gis, 1].to(torch.int64) - starts
    total = int(counts.sum()) if gis.numel() else 0
    first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
    pos = torch.repeat_interleave(starts, counts) + torch.arange(total, device=gis.device) - first
    return _pack_docs(post_data[pos], n_words)


def bitmap_from_term_range_reference(post_data, start: int, end: int, n_words: int):
    """Plain PyTorch twin of K2's range form."""
    return _pack_docs(post_data[int(start) : max(int(start), int(end))], n_words)


def _pack_docs(docs, n_words: int) -> torch.Tensor:
    docs = docs.to(torch.int64)
    docs = docs[(docs >= 0) & (docs < n_words * 32)]
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=docs.device)
    bits[docs] = 1
    shifts = torch.arange(32, dtype=torch.int64, device=docs.device)
    words = (bits.view(n_words, 32) << shifts).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _check_cuda(*tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("index kernels take contiguous int32 tensors on one device")


def launch_floor(device="cuda") -> None:
    """Launch the empty kernel ``m3_launch_floor`` through K1's and K2's
    route: what a launch costs the card, timed beside them (not counted in
    ``LAUNCHES``; nothing on the query path calls it)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    lib = load_library("index_kernels")
    with device_guard(device):
        rc = lib.m3_launch_floor(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch_floor kernel launch failed: CUDA error {rc}")
