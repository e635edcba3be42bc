"""Time units and normalization helpers.

Behavioral parity with the reference's time unit model
(upstream M3 src/x/time/unit.go:31-41,177-185): units are small integer
codes stored on the wire (a single byte after a time-unit marker), each with a
duration in nanoseconds. ``None`` (0) is a placeholder, not a real unit.
"""

from __future__ import annotations

import enum


class Unit(enum.IntEnum):
    """Wire-stable time unit codes (reference src/x/time/unit.go:31-41)."""

    NONE = 0
    SECOND = 1
    MILLISECOND = 2
    MICROSECOND = 3
    NANOSECOND = 4
    MINUTE = 5
    HOUR = 6
    DAY = 7
    YEAR = 8

    def is_valid(self) -> bool:
        return self in _UNIT_NANOS

    def nanos(self) -> int:
        """Duration of one unit in nanoseconds (unit.go:177-185)."""
        try:
            return _UNIT_NANOS[self]
        except KeyError:
            raise ValueError(f"invalid time unit {self!r}")


_UNIT_NANOS = {
    Unit.SECOND: 1_000_000_000,
    Unit.MILLISECOND: 1_000_000,
    Unit.MICROSECOND: 1_000,
    Unit.NANOSECOND: 1,
    Unit.MINUTE: 60 * 1_000_000_000,
    Unit.HOUR: 3600 * 1_000_000_000,
    Unit.DAY: 24 * 3600 * 1_000_000_000,
    Unit.YEAR: 365 * 24 * 3600 * 1_000_000_000,
}


def to_normalized(duration_nanos: int, unit: Unit) -> int:
    """Convert a duration in nanos to a count of ``unit``s (truncating)."""
    u = unit.nanos()
    # Go integer division truncates toward zero; Python floor-divides.
    q = abs(duration_nanos) // u
    return q if duration_nanos >= 0 else -q


def from_normalized(value: int, unit: Unit) -> int:
    """Convert a count of ``unit``s back to nanoseconds."""
    return value * unit.nanos()


def initial_time_unit(start_nanos: int, unit: Unit) -> Unit:
    """Pick the initial stream time unit (m3tsz/timestamp_encoder.go:208-219).

    ``unit`` is usable only when the start time is an exact multiple of it;
    otherwise the stream starts with no unit and the first write emits a
    time-unit marker.
    """
    if not unit.is_valid():
        return Unit.NONE
    if start_nanos % unit.nanos() == 0:
        return unit
    return Unit.NONE
