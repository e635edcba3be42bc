"""Wall-clock stack sampler: the host tier of continuous profiling.

Port of ``m3_tpu/profiling/sampler.py`` (Ren et al., "Google-Wide
Profiling"): a daemon thread snapshots every thread's Python stack via
``sys._current_frames()`` at a low fixed rate and folds the samples into a
bounded table of semicolon-joined stacks (the flamegraph "folded" format)
with time-windowed retention, so ``profile(seconds=N)`` answers "where did
the last N seconds go" on a live process.

- **Low overhead.** One ``sys._current_frames()`` call per tick, frame-walk
  and fold in plain Python, bounded per-bucket tables; the sampler meters
  its own cost (``m3tpu_profile_overhead_*``).
- **Deterministic scheduling.** Ticks ride a
  :class:`~m3_tpu_torch.utils.schedule.FixedRateTicker`; the clock is
  injectable, so ``sample_once`` with a fake clock and fake frames gives
  bit-identical tables.
- **Bounded everything, loudly.** Stacks deeper than ``max_depth`` keep
  their LEAF-most frames behind a ``[truncated]`` root marker
  (``m3tpu_profile_frames_truncated_total``); a bucket past
  ``max_stacks`` folds new stacks into ``[overflow]``
  (``m3tpu_profile_stacks_truncated_total``); collection failures are
  counted (``m3tpu_profile_errors_total``), never raised.
- **Profiles stay OUT of metric labels.** Frame and stack strings live in
  this table only.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from ..utils.instrument import DEFAULT as METRICS

# the stack every bucket-capped sample folds into: visible in profiles as
# "this bucket saw more distinct stacks than the table holds"
OVERFLOW_STACK = "[overflow]"
# root marker of a depth-truncated stack (leaf-most frames kept)
TRUNCATED_FRAME = "[truncated]"


def default_hz() -> float:
    """M3_TPU_PROFILE_HZ (default 19): the fleet's always-on sampling
    rate. 19 Hz is deliberately prime-ish — it cannot phase-lock with
     1s/10s periodic loops (scrapes, rulers, flush ticks) and alias their
    work into every sample. 0 disables."""
    try:
        hz = float(os.environ.get("M3_TPU_PROFILE_HZ", "19"))
    except ValueError:
        return 19.0
    return max(hz, 0.0)


def frame_label(frame) -> str:
    """One frame -> ``path/to/file.py:function``; paths shortened to the
    last three components so labels are stable across checkouts."""
    code = frame.f_code
    fname = code.co_filename.replace("\\", "/")
    parts = fname.split("/")
    short = "/".join(parts[-3:]) if len(parts) > 3 else fname
    return f"{short}:{code.co_name}"


def fold_frames(frame, max_depth: int) -> tuple[str, int]:
    """Walk a leaf frame's ``f_back`` chain into a root-first folded
    stack string. Returns ``(stack, frames_truncated)`` — stacks deeper
    than ``max_depth`` keep the LEAF-most frames (that is where the time
    is being spent) behind a ``[truncated]`` root marker."""
    labels = []
    f = frame
    while f is not None:
        labels.append(frame_label(f))
        f = f.f_back
    labels.reverse()  # root first, flamegraph convention
    truncated = 0
    if len(labels) > max_depth:
        truncated = len(labels) - max_depth
        labels = [TRUNCATED_FRAME] + labels[-max_depth:]
    return ";".join(labels), truncated


def folded_text(folded: dict) -> str:
    """Folded table -> flamegraph.pl / speedscope input: one
    ``stack count`` line per stack, hottest first."""
    lines = [
        f"{stack} {int(count)}"
        for stack, count in sorted(folded.items(), key=lambda kv: (-kv[1], kv[0]))
    ]
    return "\n".join(lines) + ("\n" if lines else "")


class StackSampler:
    """Always-on wall-clock stack sampler for one process.

    ``sample_once(now=None, frames=None)`` is the testable seam — the
    loop just calls it on the ticker schedule. ``frames`` defaults to
    ``sys._current_frames()`` (minus the sampler's own thread);
    injecting a fake mapping + a fake ``clock`` makes tables fully
    deterministic for tests.

    Retention is bucketed: samples land in ``bucket_seconds``-wide
    windows keyed by ``int(now // bucket_seconds)``; buckets older than
    ``window_seconds`` drop on the next sample. ``profile(seconds=N)``
    merges the buckets covering the last N seconds.
    """

    def __init__(
        self,
        hz: float | None = None,
        window_seconds: float = 600.0,
        bucket_seconds: float = 10.0,
        max_stacks: int = 512,
        max_depth: int = 64,
        instance: str = "",
        clock=time.monotonic,
        memory=None,
        memory_interval: float = 5.0,
        registry=None,
    ) -> None:
        self.hz = default_hz() if hz is None else max(float(hz), 0.0)
        if bucket_seconds <= 0:
            raise ValueError("bucket_seconds must be positive")
        self.window_seconds = float(window_seconds)
        self.bucket_seconds = float(bucket_seconds)
        self.max_stacks = max(int(max_stacks), 1)
        self.max_depth = max(int(max_depth), 1)
        self.instance = instance
        self.clock = clock
        # optional device-memory accountant (profiling/device.py): a
        # zero-arg callable run every ``memory_interval`` seconds on the
        # sampler's schedule, so m3tpu_device_memory_bytes{kind} stays
        # fresh without a second daemon thread
        self.memory = memory
        self.memory_interval = float(memory_interval)
        self._last_memory = None
        # bucket index -> {folded stack: count}; insertion-ordered so
        # retention drops from the front
        self._buckets: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        reg = registry or METRICS
        self._m_samples = reg.counter(
            "profile_samples_total",
            "stack-sampler ticks completed (one sys._current_frames snapshot)",
        )
        self._m_frames_trunc = reg.counter(
            "profile_frames_truncated_total",
            "frames dropped from stacks deeper than the sampler's max_depth "
            "(leaf-most frames kept behind a [truncated] root marker)",
        )
        self._m_stacks_trunc = reg.counter(
            "profile_stacks_truncated_total",
            "samples folded into the [overflow] stack because a retention "
            "bucket hit its distinct-stack cap",
        )
        self._m_errors = reg.counter(
            "profile_errors_total",
            "stack-collection or device-memory-accounting failures inside "
            "the sampler loop (a persistently growing count means profiles "
            "are going dark)",
        )
        self._m_missed = reg.counter(
            "profile_ticks_missed_total",
            "scheduled sampling ticks skipped because the loop fell a full "
            "interval behind (the schedule skips forward, never bursts)",
        )
        self._m_overhead = reg.counter(
            "profile_overhead_seconds_total",
            "wall seconds the sampler itself spent collecting and folding "
            "stacks — the numerator of the overhead estimate",
        )
        self._g_overhead = reg.gauge(
            "profile_overhead_ratio",
            "sampler seconds per wall second since start (cumulative): the "
            "always-on profiler's own cost estimate, alertable via _m3tpu",
        )
        self._overhead_seconds = 0.0
        self._started_at: float | None = None

    # -- one tick (the testable unit) --

    def sample_once(self, now: float | None = None, frames=None) -> int:
        """Take one sample: fold every thread's stack into the current
        retention bucket. Returns the number of stacks recorded. Never
        raises — failures are counted in m3tpu_profile_errors_total."""
        t0 = time.perf_counter()
        if now is None:
            now = self.clock()
        try:
            if frames is None:
                frames = sys._current_frames()
            own = self._thread.ident if self._thread is not None else None
            folded: list[tuple[str, int]] = []
            for tid, frame in frames.items():
                if tid == own:
                    continue  # the sampler observing itself is pure noise
                folded.append(fold_frames(frame, self.max_depth))
        except Exception:
            self._m_errors.inc()
            return 0
        bucket_idx = int(now // self.bucket_seconds)
        recorded = 0
        with self._lock:
            bucket = self._buckets.get(bucket_idx)
            if bucket is None:
                bucket = self._buckets[bucket_idx] = {}
                self._evict_locked(now)
            for stack, frames_trunc in folded:
                if frames_trunc:
                    self._m_frames_trunc.inc(frames_trunc)
                if stack not in bucket and len(bucket) >= self.max_stacks:
                    self._m_stacks_trunc.inc()
                    stack = OVERFLOW_STACK
                bucket[stack] = bucket.get(stack, 0) + 1
                recorded += 1
        self._m_samples.inc()
        elapsed = time.perf_counter() - t0
        self._overhead_seconds += elapsed
        self._m_overhead.inc(elapsed)
        if self._started_at is not None:
            wall = max(now - self._started_at, elapsed, 1e-9)
            self._g_overhead.set(self._overhead_seconds / wall)
        return recorded

    def _evict_locked(self, now: float) -> None:
        keep_from = int((now - self.window_seconds) // self.bucket_seconds)
        for idx in [i for i in self._buckets if i < keep_from]:
            del self._buckets[idx]

    # -- the profile surface --

    def profile(self, seconds: float | None = None) -> dict:
        """Folded-stack profile of the last ``seconds`` (default: the
        whole retention window). The returned dict is the wire/JSON shape
        the ``profile`` op and ``/debug/pprof/profile`` serve."""
        if seconds is None:
            seconds = self.window_seconds
        seconds = min(max(float(seconds), self.bucket_seconds), self.window_seconds)
        now = self.clock()
        from_idx = int((now - seconds) // self.bucket_seconds)
        merged: dict[str, int] = {}
        with self._lock:
            for idx, bucket in self._buckets.items():
                if idx < from_idx:
                    continue
                for stack, count in bucket.items():
                    merged[stack] = merged.get(stack, 0) + count
        return {
            "enabled": True,
            "instance": self.instance,
            "hz": self.hz,
            "seconds": seconds,
            "samples": sum(merged.values()),
            "folded": merged,
        }

    # -- lifecycle --

    def start(self) -> "StackSampler":
        if self.hz <= 0:
            return self
        if self._thread is None:
            self._started_at = self.clock()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="m3tpu-profiler"
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        from ..utils.schedule import FixedRateTicker

        ticker = FixedRateTicker(
            1.0 / self.hz,
            phase_key=f"profiler/{self.instance}",
            stop=self._stop,
        )
        next_memory = 0.0
        while True:
            stopped, missed = ticker.wait_next()
            if stopped:
                return
            if missed:
                self._m_missed.inc(missed)
            now = self.clock()
            self.sample_once(now=now)
            if self.memory is not None and now >= next_memory:
                next_memory = now + self.memory_interval
                try:
                    self._last_memory = self.memory()
                except Exception:
                    self._m_errors.inc()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
