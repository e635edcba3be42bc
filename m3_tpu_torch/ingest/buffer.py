"""Per-shard device column write buffer: the ingest half of residency.

Port of ``m3_tpu/ingest/buffer.py``. Write batches append into
per-block-window FRAMES of ``(series_lane, slot)`` columns -- timestamps,
values, and a per-lane cleanliness flag -- host-staged as numpy and
mirrored to device planes in batched syncs: one host-to-device copy and
one ``index_put_`` of the dirty tile a window and sync. The discipline is
the resident pool's: a sync writes the live planes in place when no reader
lease is active, else it writes a clone, which it publishes after.

The frames ring over block windows: at most ``IngestOptions.windows``
windows are open at once; a write landing outside every open window (too
old after its window sealed, or too new while the ring is full of
unsealed windows) SPILLS to the host path -- counted by reason, never
silent. Likewise a full lane table ("lanes") or a full lane ("slots").
Spilled rows still live in the shard's ``SeriesBuffer`` (the read-path
truth, which every write also lands in); a spill just means that lane
seals through the host codec instead of the device encode kernel.

A lane is CLEAN while its appends arrive strictly time-ascending (no
duplicates, no out-of-order rows). One out-of-order append marks the lane
dirty for the window (counted at seal).

Metric family: ``m3tpu_ingest_*`` (the spill counter's only label is
``reason``, a closed enum; series ids never label metrics).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..utils.instrument import DEFAULT as METRICS

SPILL_REASONS = ("window", "lanes", "slots")


@dataclass(frozen=True)
class IngestOptions:
    """Sizing for one shard's column write buffer."""

    enabled: bool = True
    lanes: int = 1024  # series lanes per block-window frame
    slots: int = 1024  # samples per lane per window
    windows: int = 2  # block windows open at once (ring depth)
    # staged appends that trigger a device-plane sync; the seal path
    # syncs explicitly, so this only bounds aggregation-feed staleness
    sync_batch: int = 8192

    def __post_init__(self):
        if self.lanes < 1 or self.slots < 1 or self.windows < 1:
            raise ValueError("lanes, slots and windows must be positive")


class SealLane(dict):
    """One sealed clean lane: ``sid``, ``times``, ``values``, ``units``
    column views (dict for tooling-friendly dumps)."""

    __getattr__ = dict.__getitem__


class _Frame:
    """Host staging for one open block window."""

    __slots__ = (
        "block_start", "lane_of", "sids", "times", "values", "units",
        "counts", "clean", "last_time", "synced",
    )

    def __init__(self, block_start: int, lanes: int, slots: int) -> None:
        self.block_start = block_start
        self.lane_of: dict[bytes, int] = {}
        self.sids: list[bytes] = []
        self.times = np.zeros((lanes, slots), np.int64)
        self.values = np.zeros((lanes, slots), np.float64)
        self.units = np.zeros((lanes, slots), np.int8)
        self.counts = np.zeros(lanes, np.int32)
        self.clean = np.ones(lanes, bool)
        self.last_time = np.full(lanes, np.iinfo(np.int64).min, np.int64)
        # per-lane slot count already mirrored to the device planes
        self.synced = np.zeros(lanes, np.int32)


class ColumnWriteBuffer:
    """Device column write buffer for ONE shard (ring of `_Frame`s), its
    planes on ``device``."""

    def __init__(self, options: IngestOptions, block_size_nanos: int, registry=None,
                 device="cuda") -> None:
        self.options = options
        self.block_size_nanos = int(block_size_nanos)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._frames: dict[int, _Frame] = {}  # block_start -> frame
        # device planes per open window, built lazily at first sync:
        # block_start -> {"cols": int32 [4, lanes, slots] (ts_hi, ts_lo,
        # val_hi, val_lo: u32 bit patterns), "counts": int32 [lanes]}
        self._planes: dict[int, dict] = {}
        self._staged_since_sync = 0
        # reader fence (resident/pool.py): aggregation readers lease the
        # planes across their reductions; a sync writes them in place only
        # when no lease is active, and new leases wait on an in-place write
        self._leases = 0
        self._donating = False
        self._fence = threading.Condition(self._lock)
        self.epoch = 0
        self.appends = 0
        self.spills = dict.fromkeys(SPILL_REASONS, 0)
        self.device_syncs = 0
        self.device_sync_bytes = 0
        self.sealed_clean_lanes = 0
        self.dirty_lane_fallbacks = 0
        reg = registry or METRICS
        self._m_appends = reg.counter(
            "ingest_appends_total", "rows accepted into the column write buffer"
        )
        self._m_spilled = {
            r: reg.counter(
                "ingest_spilled_total",
                "rows the column buffer could not take, by reason -- the "
                "row still lives in the host SeriesBuffer and its lane "
                "seals through the host codec (window: outside every "
                "open ring window; lanes: lane table full; slots: lane "
                "at capacity)",
                labels={"reason": r},
            )
            for r in SPILL_REASONS
        }
        self._m_syncs = reg.counter(
            "ingest_device_syncs_total",
            "batched column-plane scatters (host staged tail -> device)",
        )
        self._m_sync_bytes = reg.counter(
            "ingest_device_sync_bytes_total",
            "bytes moved by column-plane syncs -- the write path's ONLY "
            "host->device traffic; admission of the encoded pages moves "
            "zero (resident_upload_bytes_total stays flat on device seals)",
        )
        self._m_sealed = reg.counter(
            "ingest_sealed_clean_lanes_total",
            "lanes sealed clean: sorted/unique columns, no merge pass",
        )
        self._m_dirty = reg.counter(
            "ingest_dirty_lane_fallbacks_total",
            "lanes that went out-of-order or duplicated in-window: seal "
            "falls back to the SeriesBuffer merge for them",
        )

    # ---------- writes ----------

    def append_batch(self, sids: list, times, values, units) -> np.ndarray:
        """Append a write batch; returns a bool mask of ACCEPTED rows
        (rejected rows are spilled-by-reason; callers need no action --
        the SeriesBuffer already holds every row).

        Rows are grouped per (window, lane) so the host staging cost is
        one numpy slice assignment per group, not per row."""
        times = np.asarray(times, np.int64)
        values = np.asarray(values, np.float64)
        units = np.asarray(units, np.int8)
        n = len(times)
        accepted = np.zeros(n, bool)
        if not self.options.enabled or n == 0:
            return accepted
        bsz = self.block_size_nanos
        o = self.options
        with self._lock:
            lo_bs = (int(times.min()) // bsz) * bsz
            hi_bs = (int(times.max()) // bsz) * bsz
            if lo_bs == hi_bs:  # whole batch in one window: no grouping
                frame = self._frame_locked(lo_bs, n)
                if frame is not None:
                    self._append_frame_locked(frame, None, sids, times, values, units, accepted)
            else:
                starts = (times // bsz) * bsz
                for bs in dict.fromkeys(starts.tolist()):  # arrival order
                    rows = np.nonzero(starts == bs)[0]
                    frame = self._frame_locked(bs, len(rows))
                    if frame is None:
                        continue
                    self._append_frame_locked(
                        frame, rows, [sids[i] for i in rows.tolist()], times[rows],
                        values[rows], units[rows], accepted,
                    )
            got = int(accepted.sum())
            self.appends += got
            self._staged_since_sync += got
            self._m_appends.inc(got)
            want_sync = self._staged_since_sync >= o.sync_batch
        if want_sync:
            self.sync()
        return accepted

    def _frame_locked(self, bs: int, n_rows: int):
        frame = self._frames.get(bs)
        if frame is None:
            if len(self._frames) >= self.options.windows:
                self._spill_locked("window", n_rows)
                return None
            frame = _Frame(bs, self.options.lanes, self.options.slots)
            self._frames[bs] = frame
        return frame

    def _append_frame_locked(self, frame, rows, sids, times, values, units, accepted) -> None:
        """Stage one window's slice of a batch (``rows is None`` = the
        whole batch): lane lookup is the only per-row Python work (a
        C-level ``map`` over the sid list); slot assignment, the column
        scatters, and the cleanliness bookkeeping are grouped numpy ops."""
        o = self.options
        lane_of = frame.lane_of
        raw = list(map(lane_of.get, sids))
        if None in raw:  # new sids: assign lanes in arrival order
            for j, lane in enumerate(raw):
                if lane is None:
                    sid = sids[j]
                    lane = lane_of.get(sid)
                    if lane is None:
                        if len(frame.sids) >= o.lanes:
                            raw[j] = -1
                            continue
                        lane = len(frame.sids)
                        lane_of[sid] = lane
                        frame.sids.append(sid)
                    raw[j] = lane
            lanes_idx = np.asarray(raw, np.int64)
            full = lanes_idx < 0
            if full.any():
                self._spill_locked("lanes", int(full.sum()))
                keep = ~full
                lanes_idx = lanes_idx[keep]
                rows = np.nonzero(keep)[0] if rows is None else rows[keep]
                times, values, units = times[keep], values[keep], units[keep]
                if not len(lanes_idx):
                    return
        else:
            lanes_idx = np.asarray(raw, np.int64)
        # stable sort by lane keeps arrival order within each lane, so slot
        # positions and the dirty check see the original sequence
        order = np.argsort(lanes_idx, kind="stable")
        ls = lanes_idx[order]
        t, v, u = times[order], values[order], units[order]
        first = np.nonzero(np.r_[True, ls[1:] != ls[:-1]])[0]
        cnt = np.diff(np.append(first, len(ls)))
        cum = np.arange(len(ls)) - np.repeat(first, cnt)
        slot = frame.counts[ls].astype(np.int64) + cum
        fit = slot < o.slots
        if not fit.all():
            self._spill_locked("slots", int((~fit).sum()))
            # overflow is always a per-lane TAIL (slots ascend within a
            # lane), so groups stay contiguous after the filter
            order, ls, t, v, u, slot = order[fit], ls[fit], t[fit], v[fit], u[fit], slot[fit]
            if not len(ls):
                return
            first = np.nonzero(np.r_[True, ls[1:] != ls[:-1]])[0]
            cnt = np.diff(np.append(first, len(ls)))
        uniq = ls[first]
        frame.times[ls, slot] = t
        frame.values[ls, slot] = v
        frame.units[ls, slot] = u
        frame.counts[uniq] += cnt.astype(np.int32)
        prev = np.empty_like(t)
        prev[1:] = t[:-1]
        prev[first] = frame.last_time[uniq]
        viol = t <= prev
        if viol.any():
            frame.clean[np.unique(ls[viol])] = False
        frame.last_time[uniq] = np.maximum(frame.last_time[uniq], np.maximum.reduceat(t, first))
        accepted[order if rows is None else rows[order]] = True

    def append(self, sid: bytes, t_nanos: int, value: float, unit: int) -> bool:
        return bool(self.append_batch([sid], [t_nanos], [value], [unit])[0])

    def _spill_locked(self, reason: str, count: int = 1) -> None:
        self.spills[reason] += count
        self._m_spilled[reason].inc(count)

    # ---------- device planes (aggregation feed) ----------

    def sync(self) -> int:
        """Mirror the staged column tail to the device planes -- one
        host-to-device copy and one tile write a window, in place when no
        lease is active. Returns rows moved."""
        moved = 0
        with self._lock:
            work = []
            for bs, frame in self._frames.items():
                dirty = np.nonzero(frame.synced < frame.counts)[0]
                if len(dirty):
                    work.append((bs, frame, dirty))
            if not work:
                self._staged_since_sync = 0
                return 0
            inplace = self._leases == 0
            if inplace:
                self._donating = True
        try:
            for bs, frame, dirty in work:
                o = self.options
                planes = self._planes.get(bs)
                if planes is None:
                    planes = {
                        "cols": torch.zeros((4, o.lanes, o.slots), dtype=torch.int32,
                                            device=self.device),
                        "counts": torch.zeros(o.lanes, dtype=torch.int32, device=self.device),
                    }
                    fresh = True
                else:
                    fresh = False
                # stage only the dirty slot TAIL -- one rectangular tile
                # covering [lo, lo+w) across the dirty lanes, w and the lane
                # count padded to powers of two as the reference pads them.
                # Padding restages rows/slots already on the device with
                # identical values, so the duplicate indices write the same.
                lo = int(frame.synced[dirty].min())
                hi = int(frame.counts[dirty].max())
                w = 1 << max(hi - lo - 1, 0).bit_length()
                w = min(w, o.slots)
                lo = min(lo, o.slots - w)
                nd = 1 << max(len(dirty) - 1, 0).bit_length()
                pad = np.concatenate([dirty, np.repeat(dirty[-1], nd - len(dirty))])
                ts = frame.times[pad, lo:lo + w].view(np.uint64)
                vb = frame.values[pad, lo:lo + w].view(np.uint64)
                m32 = np.uint64(0xFFFFFFFF)
                host = np.stack([
                    (ts >> np.uint64(32)).astype(np.uint32),
                    (ts & m32).astype(np.uint32),
                    (vb >> np.uint64(32)).astype(np.uint32),
                    (vb & m32).astype(np.uint32),
                ])
                counts_host = frame.counts[pad].copy()
                # the tile and the counts cross in one staging buffer
                staged = np.concatenate([host.view(np.int32).reshape(-1), counts_host])
                dev = torch.from_numpy(staged).to(self.device)
                tile = dev[: host.size].view(4, nd, w)
                idx = torch.from_numpy(pad.astype(np.int64)).to(self.device)
                cols = planes["cols"] if inplace or fresh else planes["cols"].clone()
                counts = planes["counts"] if inplace or fresh else planes["counts"].clone()
                cols[:, idx, lo:lo + w] = tile
                counts[idx] = dev[host.size:]
                nbytes = host.nbytes + counts_host.nbytes
                moved += int((frame.counts[dirty] - frame.synced[dirty]).sum())
                with self._lock:
                    self._planes[bs] = {"cols": cols, "counts": counts}
                    frame.synced[dirty] = frame.counts[dirty]
                    self.epoch += 1
                    self.device_syncs += 1
                    self.device_sync_bytes += nbytes
                self._m_syncs.inc()
                self._m_sync_bytes.inc(nbytes)
        finally:
            with self._lock:
                self._staged_since_sync = 0
                if inplace:
                    self._donating = False
                    self._fence.notify_all()
        return moved

    def lease(self):
        """Context manager: hold the device planes stable across a reader's
        reductions (syncs write into clones meanwhile)."""
        return _Lease(self)

    def window_planes(self, block_start: int):
        """Device planes + lane sid list for one open window (the
        aggregation tier's feed), or None before the first sync."""
        with self._lock:
            planes = self._planes.get(block_start)
            frame = self._frames.get(block_start)
            if planes is None or frame is None:
                return None
            cols = planes["cols"]
            view = {
                "ts_hi": cols[0],
                "ts_lo": cols[1],
                "val_hi": cols[2],
                "val_lo": cols[3],
                "counts": planes["counts"],
            }
            return view, list(frame.sids)

    # ---------- seal ----------

    def seal_window(self, block_start: int):
        """Close one window and hand back its lanes: ``(clean, dirty)``
        where ``clean`` is a list of :class:`SealLane` (sorted, unique) and
        ``dirty`` the sids that must seal through the SeriesBuffer merge.
        The frame and its device planes are released."""
        with self._lock:
            frame = self._frames.pop(block_start, None)
            self._planes.pop(block_start, None)
            if frame is None:
                return [], []
            clean: list[SealLane] = []
            dirty: list[bytes] = []
            for lane, sid in enumerate(frame.sids):
                c = int(frame.counts[lane])
                if frame.clean[lane]:
                    clean.append(SealLane(
                        sid=sid,
                        times=frame.times[lane, :c].copy(),
                        values=frame.values[lane, :c].copy(),
                        units=frame.units[lane, :c].astype(np.int32),
                    ))
                else:
                    dirty.append(sid)
            self.sealed_clean_lanes += len(clean)
            self.dirty_lane_fallbacks += len(dirty)
            self._m_sealed.inc(len(clean))
            self._m_dirty.inc(len(dirty))
            self.epoch += 1
            return clean, dirty

    def drop_window(self, block_start: int) -> None:
        """Release a window without sealing (retention expiry)."""
        with self._lock:
            self._frames.pop(block_start, None)
            self._planes.pop(block_start, None)

    def open_windows(self) -> list[int]:
        with self._lock:
            return sorted(self._frames)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.options.enabled,
                "open_windows": sorted(self._frames),
                "appends": self.appends,
                "spills": dict(self.spills),
                "device_syncs": self.device_syncs,
                "device_sync_bytes": self.device_sync_bytes,
                "sealed_clean_lanes": self.sealed_clean_lanes,
                "dirty_lane_fallbacks": self.dirty_lane_fallbacks,
                "epoch": self.epoch,
            }


class _Lease:
    def __init__(self, buf: ColumnWriteBuffer) -> None:
        self._buf = buf

    def __enter__(self):
        buf = self._buf
        with buf._lock:
            while buf._donating:
                buf._fence.wait()
            buf._leases += 1
        return self

    def __exit__(self, *exc):
        buf = self._buf
        with buf._lock:
            buf._leases -= 1
        return False
