"""Commit log: segmented append-only WAL with rotation, replay and cleanup.

Reference: M3's src/dbnode/persist/fs/commitlog/ — NewCommitLog
(commit_log.go:249), batched async writes behind a single writer
(writeBehind :804), flush interval/fsync policy, RotateLogs (:370), chunked
reader (reader.go).

The log is a directory of numbered segment files (``commitlog-<seq>.wal``).
Rotation seals the active segment and opens the next; sealed segments are
only DELETED once their entries are durable elsewhere (flushed filesets
and/or snapshot files — the reference removes commit logs only when covered
by snapshots, commit_log cleanup in storage/cleanup.go). Replay walks all
segments in sequence order and tolerates a torn final record. Record CRCs
cover series_id AND payload so a corrupted id cannot replay datapoints into
the wrong series.

A copy of ``m3_tpu/storage/commitlog.py``; the segment bytes are the
reference's. One divergence, on purpose: in write-behind mode the
reference's ``cleanup`` / ``remove_inactive`` / ``inactive_segments`` read
the directory while records enqueued before the call may still sit in the
writer's queue, so a caller that lists or replays the log right after them
races the writer thread (``tests/test_storage.py::
test_commitlog_rotation_and_cleanup`` failed that way once in a while).
Here they are barriers on the writer: everything enqueued before the call
is appended first. The bytes written are the same.
"""

from __future__ import annotations

import errno
import os
import queue
import re
import struct
import threading
import time
import zlib
from dataclasses import dataclass

from ..utils.instrument import DEFAULT as METRICS
from ..utils.xtime import Unit
from .faults import DISK, DiskFullError, crash_point

_MAGIC = 0x6D33574C  # "m3WL"
_HDR = struct.Struct("<IHI")  # crc32 of (series_id + payload), id len, payload len
_SEG_RE = re.compile(r"^commitlog-(\d+)\.wal$")

_ENOSPC_ERRNOS = (errno.ENOSPC, errno.EDQUOT)

# disk-full degrade surface: one process-wide gauge (any commit log
# degraded), one event counter. Per-log state lives on the instance; the
# registry aggregates here so the SLO plane sees capacity pressure.
_DISK_FULL_GAUGE = METRICS.gauge(
    "storage_disk_full",
    "1 while any commit log is in disk-full degraded mode",
)
_DISK_FULL_EVENTS = METRICS.counter(
    "storage_disk_full_events_total",
    "commit log disk-full degrade events",
)
_degraded_dirs: set = set()
_degraded_lock = threading.Lock()


def _mark_degraded(dir_path: str, on: bool) -> None:
    with _degraded_lock:
        if on:
            _degraded_dirs.add(dir_path)
        else:
            _degraded_dirs.discard(dir_path)
        _DISK_FULL_GAUGE.set(1.0 if _degraded_dirs else 0.0)


@dataclass
class CommitLogEntry:
    series_id: bytes
    time_nanos: int
    value: float
    unit: Unit = Unit.SECOND
    annotation: bytes = b""


def _seg_path(dir_path: str, seq: int) -> str:
    return os.path.join(dir_path, f"commitlog-{seq}.wal")


def _list_segments(dir_path: str) -> list[tuple[int, str]]:
    try:
        names = os.listdir(dir_path)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        m = _SEG_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(dir_path, n)))
    return sorted(out)


class CommitLog:
    """Segmented WAL with WRITE-BEHIND: callers enqueue onto a bounded
    queue and return immediately; a single writer thread drains the queue,
    appends, and fsyncs when either ``flush_every`` records are pending or
    ``flush_interval`` seconds have elapsed with anything pending — the
    reference's single writer goroutine + flush interval/fsync policy
    (commit_log.go:293 writerLoop, :408/:804 writeBehind). The loss window
    on a hard kill is therefore bounded by the flush interval, even at
    arbitrarily low write rates.

    ``flush()`` is a durability barrier: it blocks until every previously
    enqueued record is appended AND fsynced. ``write_behind=False`` gives
    the fully synchronous mode (tests, tools)."""

    _SENTINEL = object()

    def __init__(
        self,
        dir_path: str,
        flush_every: int = 64,
        flush_interval: float = 1.0,
        write_behind: bool = True,
        queue_size: int = 65536,
        degraded_retry_interval: float = 0.05,
    ) -> None:
        self.dir = dir_path
        self.flush_every = flush_every
        self.flush_interval = flush_interval
        self.write_behind = write_behind
        self.degraded_retry_interval = degraded_retry_interval
        # set to the triggering OSError while the log is parked in
        # disk-full degraded mode; cleared when a retry succeeds
        self._degraded: BaseException | None = None
        self._parked: list = []  # dequeued cmds being retried while degraded
        # the writer thread owns the file; this lock only guards the
        # synchronous mode and open/close edges
        self._wlock = threading.RLock()
        os.makedirs(dir_path, exist_ok=True)
        segs = _list_segments(dir_path)
        # a fresh segment per open — the previous process's tail stays sealed
        self.active_seq = (segs[-1][0] + 1) if segs else 0
        self._f = self._open_segment(self.active_seq)
        self._pending = 0
        self._active_entries = 0
        self._closed = False
        self._failed: BaseException | None = None
        self._inflight = None  # command being served by the writer thread
        # serializes enqueue vs close: once close() wins, no barrier/entry
        # command can slip into the queue behind the 'close' command (it
        # would never be serviced — its waiter would hang forever). The
        # writer thread never takes this lock, so a blocked bounded put
        # under it still drains.
        self._qlock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._writer: threading.Thread | None = None
        if write_behind:
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True, name="commitlog-writer"
            )
            self._writer.start()

    def _open_segment(self, seq: int):
        path = _seg_path(self.dir, seq)
        f = DISK.open(path, "ab")
        self._fpath = path
        if f.tell() == 0:
            DISK.write(f, path, struct.pack("<I", _MAGIC))
            DISK.fsync(f, path)
        return f

    # --- caller-facing surface ---

    def _check_failed(self) -> None:
        if self._failed is not None:
            raise RuntimeError("commit log writer failed") from self._failed

    @property
    def disk_full(self) -> bool:
        """True while the log is parked in disk-full degraded mode: new
        writes are shed with the typed retryable :class:`DiskFullError`
        instead of being acked into a WAL that cannot land them."""
        return self._degraded is not None

    def _check_disk_full(self) -> None:
        if self._degraded is not None:
            raise DiskFullError(f"commit log disk full: {self.dir}")

    def _enter_degraded(self, exc: OSError) -> None:
        if self._degraded is None:
            _DISK_FULL_EVENTS.inc()
            _mark_degraded(self.dir, True)
        self._degraded = exc

    def _clear_degraded(self) -> None:
        if self._degraded is not None:
            self._degraded = None
            _mark_degraded(self.dir, False)

    def _enqueue(self, cmd) -> bool:
        """Enqueue unless closed. Returns False when the log is closed."""
        with self._qlock:
            if self._closed:
                return False
            self._q.put(cmd)
            return True

    def write(self, entry: CommitLogEntry) -> None:
        if self.write_behind:
            self._check_disk_full()  # shed instead of acking into a parked WAL
            if not self._enqueue(("entry", entry)):  # blocks when full
                self._check_failed()
                raise ValueError("commit log is closed")
        else:
            with self._wlock:
                if self._closed:
                    raise ValueError("commit log is closed")
                try:
                    self._append(entry)
                    if self._pending >= self.flush_every:
                        self._fsync()
                except OSError as exc:
                    self._map_sync_oserror(exc)
                self._clear_degraded()

    def write_batch(self, entries: list[CommitLogEntry]) -> None:
        if self.write_behind:
            self._check_disk_full()
            # ONE queue command for the whole batch: per-entry queue puts
            # were ~6µs each and dominated batched ingest
            if not self._enqueue(("batch", entries)):
                self._check_failed()
                raise ValueError("commit log is closed")
        else:
            with self._wlock:
                if self._closed:
                    raise ValueError("commit log is closed")
                try:
                    for e in entries:
                        self._append(e)
                    self._fsync()
                except OSError as exc:
                    self._map_sync_oserror(exc)
                self._clear_degraded()

    def _map_sync_oserror(self, exc: OSError) -> None:
        """Sync-mode failure mapping: ENOSPC degrades to the typed
        retryable DiskFullError (a duplicate re-append after the caller's
        retry is benign — replay dedupes (sid, t) last-wins); anything
        else propagates as the hard failure it is."""
        if exc.errno in _ENOSPC_ERRNOS:
            self._enter_degraded(exc)
            raise DiskFullError(f"commit log disk full: {self.dir}") from exc
        raise exc

    def flush(self) -> None:
        """Durability barrier: everything enqueued before this call is on
        disk when it returns. No-op after close (close fsyncs). While
        disk-full degraded the barrier cannot be met — fail typed-retryable
        rather than blocking until space frees."""
        if self.write_behind:
            self._check_disk_full()
            ev = threading.Event()
            if self._enqueue(("flush", ev)):
                ev.wait()
            self._check_failed()
            self._check_disk_full()
        else:
            with self._wlock:
                if not self._closed:
                    try:
                        self._fsync()
                    except OSError as exc:
                        self._map_sync_oserror(exc)
                    self._clear_degraded()

    def rotate(self) -> int:
        """RotateLogs (:370): seal the active segment, open the next.
        Returns the sealed segment's sequence number. Rotating an EMPTY
        active segment is a no-op (a periodic mediator would otherwise
        mint one segment file per pass)."""
        if self.write_behind:
            ev = threading.Event()
            holder: list[int] = []
            if not self._enqueue(("rotate", ev, holder)):
                return self.active_seq
            ev.wait()
            return holder[0]
        with self._wlock:
            if self._closed:
                return self.active_seq
            return self._rotate_now()

    def close(self) -> None:
        if self.write_behind:
            with self._qlock:
                if self._closed:
                    return
                self._closed = True  # no further command can follow 'close'
                ev = threading.Event()
                self._q.put(("close", ev))
            ev.wait()
            if self._writer is not None:
                self._writer.join(timeout=5)
                self._writer = None
        else:
            with self._wlock:
                if not self._closed:
                    self._fsync()
                    self._f.close()
                    self._closed = True

    # --- writer thread (single owner of the file in write-behind mode) ---

    def _writer_loop(self) -> None:
        try:
            self._writer_loop_inner()
        except BaseException as exc:  # disk full, fd error, ...
            # a dead writer must not hang the process: record the failure,
            # refuse further work, and release every barrier waiter —
            # INCLUDING the command that was in flight when the failure
            # struck (it was already dequeued, so the drain below would
            # miss it). Callers re-raise via _check_failed.
            self._failed = exc
            with self._qlock:
                self._closed = True
            # Neutralize the file object: a dead writer's BufferedWriter
            # must never flush/close at GC time — fd numbers get reused,
            # and a GC-time flush was observed writing stale bytes into
            # (then closing) an UNRELATED database's WAL. dup2(devnull)
            # makes the object's fd harmless whether the original fd is
            # broken-but-open (disk error) or already closed.
            try:
                devnull = os.open(os.devnull, os.O_WRONLY)
                try:
                    os.dup2(devnull, self._f.fileno())
                finally:
                    os.close(devnull)
                self._f.close()
            except (OSError, ValueError):
                pass

            def release(cmd) -> None:
                if cmd is None:
                    return
                if cmd[0] in ("flush", "close"):
                    cmd[1].set()
                elif cmd[0] == "rotate":
                    cmd[2].append(self.active_seq)
                    cmd[1].set()

            release(self._inflight)
            self._inflight = None
            # commands dequeued into the degraded-retry park must release
            # too — they are no longer in the queue, so the drain below
            # would miss their waiters
            for cmd in self._parked:
                release(cmd)
            self._parked = []
            try:
                while True:
                    release(self._q.get_nowait())
            except queue.Empty:
                pass

    def _writer_loop_inner(self) -> None:
        last_fsync = time.monotonic()
        while True:
            self._inflight = None
            timeout = None
            if self._pending:
                timeout = max(
                    0.0, self.flush_interval - (time.monotonic() - last_fsync)
                )
            try:
                cmd = self._q.get(timeout=timeout)
            except queue.Empty:
                cmd = ("fsync",)  # interval elapsed with records pending
            self._inflight = cmd
            try:
                done = self._process_cmd(cmd)
            except OSError as exc:
                if exc.errno not in _ENOSPC_ERRNOS:
                    raise
                done = self._degraded_drain(cmd, exc)
            last_fsync = time.monotonic()
            if done:
                return

    def _process_cmd(self, cmd) -> bool:
        """Serve one writer command; True means the log just closed.
        Shared between the healthy loop and the degraded-retry loop —
        re-serving a command whose first attempt partially appended is
        safe because replay dedupes (sid, t) last-wins at bootstrap."""
        kind = cmd[0]
        if kind == "fsync":
            self._fsync()
        elif kind == "entry":
            self._append(cmd[1])
            if self._pending >= self.flush_every:
                self._fsync()
        elif kind == "batch":
            for e in cmd[1]:
                self._append(e)
            if self._pending >= self.flush_every:
                self._fsync()
        elif kind == "flush":
            self._fsync()
            cmd[1].set()
        elif kind == "rotate":
            cmd[2].append(self._rotate_now())
            cmd[1].set()
        elif kind == "close":
            self._fsync()
            self._f.close()
            cmd[1].set()
            return True
        return False

    def _degraded_drain(self, first_cmd, exc: OSError) -> bool:
        """Disk full: park instead of dying. New writes shed typed-
        retryable (see ``write``); everything already accepted — the
        failed command plus whatever queued behind it — retries in FIFO
        order until space frees, so no acked record is dropped and no
        ordering inverts. A close while still full force-closes (the
        caller is tearing the process down; spinning against a dead-full
        disk would hang shutdown forever). Returns True when the log
        closed during the drain."""
        self._enter_degraded(exc)
        self._parked = [first_cmd] if first_cmd[0] != "fsync" else []
        while True:
            try:
                while True:
                    self._parked.append(self._q.get_nowait())
            except queue.Empty:
                pass
            try:
                while self._parked:
                    done = self._process_cmd(self._parked[0])
                    self._parked.pop(0)
                    if done:
                        self._clear_degraded()
                        return True
                self._fsync()  # park entered with unsynced appends pending
                self._clear_degraded()
                return False
            except OSError as retry_exc:
                if retry_exc.errno not in _ENOSPC_ERRNOS:
                    raise
                self._enter_degraded(retry_exc)
                if any(c[0] == "close" for c in self._parked):
                    self._force_close_degraded()
                    return True
                time.sleep(self.degraded_retry_interval)

    def _force_close_degraded(self) -> None:
        """Close against a still-full disk: neutralize the file object
        (python-buffered bytes must not flush at GC time into a reused
        fd — see _crash) and release every parked waiter. Records parked
        but never landed are lost, the same bound as a process kill here;
        the on-disk WAL stays a clean torn tail that replay tolerates."""
        with self._qlock:
            self._closed = True
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            try:
                os.dup2(devnull, self._f.fileno())
            finally:
                os.close(devnull)
            self._f.close()
        except (OSError, ValueError):
            pass  # fd neutralization is best-effort; waiters still release
        for cmd in self._parked:
            if cmd[0] in ("flush", "close"):
                cmd[1].set()
            elif cmd[0] == "rotate":
                cmd[2].append(self.active_seq)
                cmd[1].set()
        self._parked = []

    # --- file ops (writer thread in write-behind mode; else under _wlock) ---

    def _append(self, entry: CommitLogEntry) -> None:
        payload = (
            struct.pack(
                "<qdBH",
                entry.time_nanos,
                entry.value,
                int(entry.unit),
                len(entry.annotation),
            )
            + entry.annotation
        )
        crc = zlib.crc32(entry.series_id + payload)
        rec = _HDR.pack(crc, len(entry.series_id), len(payload)) + entry.series_id + payload
        DISK.write(self._f, self._fpath, rec)
        self._pending += 1
        self._active_entries += 1

    def _fsync(self) -> None:
        DISK.fsync(self._f, self._fpath)
        self._pending = 0

    def _rotate_now(self) -> int:
        sealed = self.active_seq
        if self._active_entries == 0:
            return sealed
        self._fsync()
        self._f.close()
        # the sealed segment is durable and closed; the next one does not
        # exist yet — the exact torn state a rotation-time kill leaves
        crash_point("commitlog:mid-rotation")
        self.active_seq += 1
        self._f = self._open_segment(self.active_seq)
        self._pending = 0
        self._active_entries = 0
        return sealed

    def _crash(self) -> None:
        """TEST ONLY: simulate a hard process kill (SIGKILL). Acked writes
        still sitting in the queue die; so does the Python-level file
        buffer. Bytes already written through to the OS survive, exactly as
        they would a real process death."""
        self._closed = True
        try:
            while True:
                cmd = self._q.get_nowait()
                if cmd[0] in ("flush", "close"):
                    cmd[1].set()  # unblock any barrier waiter
                elif cmd[0] == "rotate":
                    cmd[2].append(self.active_seq)
                    cmd[1].set()
        except queue.Empty:
            pass
        # Lose the Python-buffered bytes WITHOUT leaving a zombie file
        # object: redirect the fd to /dev/null and close normally. A bare
        # os.close left the BufferedWriter "open" holding a dead fd number;
        # its flush at GC time then wrote stale bytes into (and closed!)
        # whatever unrelated file had REUSED that fd — observed as a
        # different database's WAL writer dying with EBADF mid-test-suite.
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, self._f.fileno())  # real file keeps only
            os.close(devnull)  # what the OS already had (SIGKILL bytes)
            self._f.close()  # buffer flushes harmlessly into /dev/null
        except (OSError, ValueError):
            pass

    # --- cleanup (storage/cleanup.go commit-log removal semantics) ---

    def _barrier(self) -> None:
        """Wait until the writer thread has served every command enqueued
        before this call (a flush: the bytes land, none change). Skipped
        while the log is closed or parked disk-full: nothing lands then,
        and cleanup is how space frees."""
        if not self.write_behind or self._degraded is not None:
            return
        ev = threading.Event()
        if self._enqueue(("flush", ev)):
            ev.wait()

    def inactive_segments(self) -> list[tuple[int, str]]:
        """Sealed segments, oldest first, as of this call: a barrier on the
        writer, so a rotation or append enqueued before it has landed."""
        self._barrier()
        return [(s, p) for s, p in _list_segments(self.dir) if s < self.active_seq]

    def cleanup(self, covered) -> int:
        """Delete sealed segments in which EVERY entry satisfies ``covered``
        (a predicate CommitLogEntry -> bool, i.e. durable elsewhere),
        OLDEST-FIRST and stopping at the first retained segment — the
        surviving WAL must stay a contiguous SUFFIX of write history.
        Deleting a newer segment around an older survivor would let the
        survivor's stale same-timestamp entries win replay's last-wins
        ordering over values that now live only in filesets.
        Returns the number of segments removed."""
        removed = 0
        for _, path in self.inactive_segments():
            if not all(covered(e) for e in self.replay_segment(path)):
                break
            os.remove(path)
            removed += 1
        return removed

    def remove_inactive(self) -> int:
        """Delete ALL sealed segments (caller guarantees coverage, e.g. a
        just-written snapshot of every buffer)."""
        removed = 0
        for _, path in self.inactive_segments():
            os.remove(path)
            removed += 1
        return removed

    # --- replay (reader.go) ---

    @staticmethod
    def replay_segment(path: str) -> list[CommitLogEntry]:
        """Stream records from one segment; stop cleanly at a torn tail."""
        out: list[CommitLogEntry] = []
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            return out
        if len(buf) < 4 or struct.unpack_from("<I", buf, 0)[0] != _MAGIC:
            return out
        pos = 4
        while pos + _HDR.size <= len(buf):
            crc, id_len, p_len = _HDR.unpack_from(buf, pos)
            start = pos + _HDR.size
            end = start + id_len + p_len
            if end > len(buf):
                break  # torn tail
            sid = buf[start : start + id_len]
            payload = buf[start + id_len : end]
            if zlib.crc32(sid + payload) != crc:
                break  # corruption: stop replay (reference surfaces an error)
            t, v, unit, ann_len = struct.unpack_from("<qdBH", payload, 0)
            ann = payload[19 : 19 + ann_len]
            out.append(CommitLogEntry(sid, t, v, Unit(unit), ann))
            pos = end
        return out

    @staticmethod
    def replay(dir_path: str) -> list[CommitLogEntry]:
        """All entries across all segments, in write order."""
        out: list[CommitLogEntry] = []
        for _, path in _list_segments(dir_path):
            out.extend(CommitLog.replay_segment(path))
        return out
