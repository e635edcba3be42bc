"""Fixed-rate scheduling with deterministic phase jitter.

A copy of ``m3_tpu/utils/schedule.py`` (the stack sampler's loop needs it).
Periodic loops must not drift and must not align: a
``stop.wait(interval)`` loop accumulates per-iteration work time into its
period, and every process waking at ``t0 + k*interval`` with the same t0
phase wakes together. :class:`FixedRateTicker` fires at the absolute
monotonic instants ``start + phase + k*interval`` (work time eats into the
wait, not the period), with ``phase`` a DETERMINISTIC per-instance fraction
of the interval hashed from a caller-supplied key. A loop that falls more
than a full interval behind SKIPS the missed ticks rather than firing them
back to back, and reports how many were skipped.
"""

from __future__ import annotations

import threading
import time

from .hash import murmur3_32

# The floor for any periodic loop that STORES series about the fleet
# (self-scrape collector, ruler group evaluation, SLO status/probes).
# Stored timestamps ride the m3tsz SECOND-unit delta encoding, so two
# samples of one series closer than 1s collapse onto the same stored
# timestamp — the series stays queryable but every rate()/increase()
# over it flattens, which silently falsifies exactly the derived
# signals (error rates, burn rates) these loops exist to produce.
# Config loaders reject sub-second intervals LOUDLY against this
# constant instead of degrading; loops that never store series
# (health probes, failure detectors) are exempt.
MIN_TELEMETRY_INTERVAL_SECS = 1.0


def check_telemetry_interval(interval: float, what: str) -> float:
    """Validate a stored-telemetry loop interval at config load.

    Returns the interval; raises ``ValueError`` naming the caller's
    config knob when ``interval`` is positive but under the m3tsz
    second-unit floor (see :data:`MIN_TELEMETRY_INTERVAL_SECS`)."""
    iv = float(interval)
    if 0 < iv < MIN_TELEMETRY_INTERVAL_SECS:
        raise ValueError(
            f"{what} interval {iv!r}s is below the "
            f"{MIN_TELEMETRY_INTERVAL_SECS:g}s floor: stored timestamps "
            "ride m3tsz SECOND-unit deltas, so sub-second samples "
            "collapse onto one stored timestamp and flatten every "
            "rate() derived from this telemetry"
        )
    return iv


def phase_fraction(key: str) -> float:
    """Deterministic jitter fraction in [0, 1) for a scheduling key.

    murmur3 (the shard hash — stable across processes and runs, unlike
    Python's randomized ``hash``) of the key, scaled to a fraction: the
    same instance always lands on the same phase, and distinct instances
    spread ~uniformly."""
    return (murmur3_32(key.encode("utf-8", "replace")) % (1 << 20)) / float(1 << 20)


class FixedRateTicker:
    """Absolute-schedule tick source for a periodic daemon loop.

    Usage::

        ticker = FixedRateTicker(interval, phase_key=instance, stop=stop_evt)
        while True:
            stopped, missed = ticker.wait_next()
            if stopped:
                break
            if missed:
                missed_counter.inc(missed)
            do_work()

    ``clock`` is injectable (monotonic seconds) for tests; the stop event
    doubles as the wait primitive so ``stop.set()`` interrupts a sleeping
    loop immediately.
    """

    def __init__(
        self,
        interval: float,
        phase_key: str = "",
        stop: threading.Event | None = None,
        clock=time.monotonic,
        jitter: bool = True,
    ) -> None:
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval!r}")
        self.interval = float(interval)
        self.stop = stop if stop is not None else threading.Event()
        self.clock = clock
        self.phase = (
            phase_fraction(phase_key) * self.interval if jitter else 0.0
        )
        self._start = self.clock()
        self._k = 0  # last fired tick index

    def next_deadline(self) -> float:
        """Absolute (monotonic) instant of the next scheduled tick."""
        return self._start + self.phase + (self._k + 1) * self.interval

    def wait_next(self) -> tuple[bool, int]:
        """Block until the next scheduled tick (or stop). Returns
        ``(stopped, missed)`` where ``missed`` counts whole intervals
        skipped because the loop fell behind schedule."""
        self._k += 1
        target = self._start + self.phase + self._k * self.interval
        now = self.clock()
        missed = 0
        if now > target:
            missed = int((now - target) // self.interval)
            if missed:
                self._k += missed
                target = self._start + self.phase + self._k * self.interval
        delay = max(0.0, target - now)
        stopped = self.stop.wait(delay) if delay > 0 else self.stop.is_set()
        return bool(stopped), missed
