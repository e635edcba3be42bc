"""Budget-capped store of device-resident index segments.

Port of ``m3_tpu/index/device/store.py``. Sealed segments admit at seal
time, evict LRU under one device byte budget, and route to the host
executor when absent (counted as misses, the reason on the wrapper's
``status()``). Admission stages on the host and UPLOADS OUTSIDE every lock
(one host-to-device copy per segment, then views on the device), reserves
budget under the store lock before the upload and publishes after — so an
upload never stalls queries or writers, and an invalidation racing the
upload drops the pending tier instead of publishing a stale one.

Admission can REJECT a segment (stays host-only, wrapper records why):
- ``term-too-long``: a term over ``MAX_TERM_BYTES`` would need a wider
  fixed-width key than the kernels' compare covers (no truncation —
  a truncated compare could return wrong doc ids);
- ``over-budget``: the segment alone exceeds the whole budget;
- ``empty``: nothing to index.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ... import resolve_device
from ...utils.config import ConfigError
from ...utils.instrument import DEFAULT as METRICS
from . import kernels
from .segment import DeviceArrays, DeviceSegment


# fixed-width key cap (see the module docstring)
MAX_TERM_BYTES = 64


@dataclass
class IndexDeviceOptions:
    """Knobs for the device index tier. ``max_bytes`` is the device byte
    budget; the default 1 GiB holds the index of some 20M series of ten
    tags, and 0 turns the tier off."""

    max_bytes: int = 1 << 30

    def validate(self) -> None:
        if self.max_bytes < 0:
            raise ConfigError("index_device.max_bytes must be >= 0")


class DeviceIndexStore:
    """LRU of device-resident segments under one byte budget, on
    ``device`` (default the card; ``"cpu"`` runs the kernels' twins)."""

    def __init__(self, options: IndexDeviceOptions | None = None,
                 registry=None, device="cuda") -> None:
        self.options = options or IndexDeviceOptions()
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._od: "OrderedDict[int, DeviceSegment]" = OrderedDict()
        self._bytes = 0
        self.admissions = 0
        self.rejections = 0
        self.evictions = 0
        self.invalidations = 0
        self.search_hits = 0
        self.search_misses = 0
        self.errors = 0
        reg = registry or METRICS
        self._m_admissions = reg.counter(
            "index_device_admissions_total",
            "sealed index segments admitted to the device tier",
        )
        self._m_rejections = reg.counter(
            "index_device_rejections_total",
            "segments refused at admission (term-too-long / over-budget)",
        )
        self._m_evictions = reg.counter(
            "index_device_evictions_total", "LRU/budget segment evictions"
        )
        self._m_invalidations = reg.counter(
            "index_device_invalidations_total",
            "segments dropped because they were superseded or expired",
        )
        self._m_hits = reg.counter(
            "index_device_search_hits_total",
            "segment searches answered by the device executor",
        )
        self._m_misses = reg.counter(
            "index_device_search_misses_total",
            "segment searches routed to the host executor (not resident or "
            "an AST node the device does not model)",
        )
        self._m_errors = reg.counter(
            "index_device_errors_total",
            "device evaluation faults (build, launch or kernel errors); each "
            "one is raised to the query, never answered from the host",
        )
        self._g_bytes = reg.gauge(
            "index_device_bytes", "device bytes held by resident index segments"
        )
        self._g_segments = reg.gauge(
            "index_device_segments", "segments currently device-resident"
        )

    # ---------- surface ----------

    @property
    def enabled(self) -> bool:
        return self.options.max_bytes > 0

    def __len__(self) -> int:
        return len(self._od)

    def device_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def admit(self, host_seg, block_start: int | None = None,
              label: str = "") -> DeviceSegment:
        """Wrap ``host_seg`` and (if it fits) build + upload its device
        tier. ALWAYS returns a wrapper — a rejected or disabled segment
        keeps serving through the host surface, with the refusal reason
        on ``status()``."""
        seg = DeviceSegment(host_seg, self, block_start=block_start,
                            label=label)
        if not self.enabled:
            seg._state = "not-admitted:disabled"
            return seg
        staged = self._build_host(host_seg)
        if isinstance(staged, str):
            seg._state = f"not-admitted:{staged}"
            with self._lock:
                self.rejections += 1
                self._m_rejections.inc()
            return seg
        flat, parts = staged
        nbytes = int(flat.nbytes)
        if nbytes > self.options.max_bytes:
            seg._state = "not-admitted:over-budget"
            with self._lock:
                self.rejections += 1
                self._m_rejections.inc()
            return seg
        with self._lock:
            # reserve budget BEFORE the upload so concurrent admissions
            # can't collectively overshoot; the entry is pending (arrays
            # None) and invisible to the device path until published
            while self._bytes + nbytes > self.options.max_bytes:
                if not self._evict_one_locked():
                    break
            if self._bytes + nbytes > self.options.max_bytes:
                self.rejections += 1
                self._m_rejections.inc()
                seg._state = "not-admitted:over-budget"
                return seg
            self._od[id(seg)] = seg
            seg._reserved = nbytes
            self._bytes += nbytes
            self._publish_locked()
        arrays = self._upload(flat, parts, nbytes)
        with self._lock:
            if id(seg) not in self._od:
                # invalidated/evicted mid-upload: never publish
                return seg
            seg._arrays = arrays
            seg._state = "resident"
            self.admissions += 1
            self._m_admissions.inc()
        return seg

    def touch(self, seg: DeviceSegment) -> None:
        with self._lock:
            if id(seg) in self._od:
                self._od.move_to_end(id(seg))

    def invalidate(self, seg) -> None:
        """Drop a superseded/expired segment's device tier (ns_index
        calls this when persist compaction or retention replaces it)."""
        if not isinstance(seg, DeviceSegment):
            return
        with self._lock:
            if self._drop_locked(seg, "invalidated"):
                self.invalidations += 1
                self._m_invalidations.inc()

    def clear(self) -> int:
        with self._lock:
            n = 0
            for seg in list(self._od.values()):
                if self._drop_locked(seg, "invalidated"):
                    n += 1
            self.invalidations += n
            self._m_invalidations.inc(n)
            return n

    # ---------- accounting (called by DeviceSegment) ----------

    def count_search(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.search_hits += 1
            else:
                self.search_misses += 1
        (self._m_hits if hit else self._m_misses).inc()

    def count_error(self) -> None:
        with self._lock:
            self.errors += 1
        self._m_errors.inc()

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "segments": len(self._od),
                "bytes": self._bytes,
                "max_bytes": self.options.max_bytes,
                "admissions": self.admissions,
                "rejections": self.rejections,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "search_hits": self.search_hits,
                "search_misses": self.search_misses,
                "errors": self.errors,
            }

    # ---------- internals ----------

    def _drop_locked(self, seg: DeviceSegment, state: str) -> bool:
        if self._od.pop(id(seg), None) is None:
            return False
        self._bytes -= getattr(seg, "_reserved", 0)
        seg._arrays = None  # device buffers free with the references
        seg._state = state
        self._publish_locked()
        return True

    def _evict_one_locked(self) -> bool:
        if not self._od:
            return False
        _, seg = next(iter(self._od.items()))
        self._drop_locked(seg, "evicted")
        self.evictions += 1
        self._m_evictions.inc()
        return True

    def _publish_locked(self) -> None:
        self._g_bytes.set(float(self._bytes))
        self._g_segments.set(float(len(self._od)))

    def _build_host(self, host_seg):
        """Host staging: one flat int32 buffer holding the key matrix,
        lengths, postings data and the all-docs bitmap (uploaded in one
        transfer), plus the side parts; the postings index stays on the
        host (K2's spans are laid out there). Returns a
        rejection reason string instead when the segment can't take a
        device tier."""
        n_docs = len(host_seg)
        if n_docs == 0:
            return "empty"
        terms_all: list[bytes] = []
        idx_rows: list[tuple[int, int]] = []
        chunks: list[np.ndarray] = []
        fields: dict[bytes, tuple[int, int, int, int]] = {}
        max_len = 1
        offset = 0
        dot_safe = True  # no term contains \n (see DeviceArrays.dot_safe)
        for name in host_seg.fields():
            start = len(terms_all)
            data_start = offset
            for t, p in _iter_term_postings(host_seg, name):
                t = bytes(t)
                if len(t) > MAX_TERM_BYTES:
                    return "term-too-long"
                if b"\n" in t:
                    dot_safe = False
                max_len = max(max_len, len(t))
                terms_all.append(t)
                p = np.asarray(p, np.int32)
                chunks.append(p)
                idx_rows.append((offset, offset + len(p)))
                offset += len(p)
            # a field's postings are one contiguous [data_start, offset)
            # run of post_data: terms append field by field
            fields[bytes(name)] = (
                start, len(terms_all) - start, data_start, offset
            )
        if not terms_all:
            return "empty"
        k_words = kernels.key_width_words(max_len)
        keys, lens = kernels.build_term_keys(terms_all, k_words)
        post_idx = np.asarray(idx_rows, np.int64)
        all_words = kernels.all_docs_words(n_docs)
        flat = np.concatenate([
            keys.ravel().view(np.int32),
            lens,
            np.concatenate(chunks).astype(np.int32, copy=False),
            all_words.view(np.int32),
        ])
        parts = {
            "fields": fields,
            "k_words": k_words,
            "n_terms": len(terms_all),
            "n_post": offset,
            "n_docs": n_docs,
            "n_words": len(all_words),
            "host_keys": keys,
            "host_lens": lens,
            "host_post_idx": post_idx,
            "dot_safe": dot_safe,
        }
        return flat, parts

    def _upload(self, flat: np.ndarray, parts: dict, nbytes: int) -> DeviceArrays:
        """ONE host-to-device copy of the staged buffer, then views of it
        in the kernels' operand shapes. No lock is held here: segment
        uploads are independent."""
        n, k, p = parts["n_terms"], parts["k_words"], parts["n_post"]
        dev = torch.from_numpy(flat).to(self.device)
        o = n * k
        term_keys = dev[:o].view(n, k)
        term_lens = dev[o : o + n]
        o += n
        post_data = dev[o : o + p]
        all_words = dev[o + p :]
        return DeviceArrays(
            term_keys=term_keys,
            term_lens=term_lens,
            post_data=post_data,
            all_words=all_words,
            fields=parts["fields"],
            k_words=k,
            n_docs=parts["n_docs"],
            n_words=parts["n_words"],
            nbytes=nbytes,
            host_keys=parts["host_keys"],
            host_lens=parts["host_lens"],
            host_post_idx=parts["host_post_idx"],
            dot_safe=parts["dot_safe"],
        )


def _iter_term_postings(seg, name: bytes):
    if hasattr(seg, "iter_term_postings"):
        yield from seg.iter_term_postings(name)
    else:
        for t in seg.terms(name):
            yield t, seg.postings(name, t)
