"""Storage policies: resolution + retention.

A copy of ``m3_tpu/metrics/policy.py`` (plain Python).

Reference: M3's src/metrics/policy/storage_policy.go — string form
"<resolution>:<retention>" e.g. "10s:2d" (:85-167), with optional
"<resolution>@<precision>" resolution form (resolution.go).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

NANOS = 1_000_000_000

_UNITS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,
    "ms": 1_000_000,
    "s": NANOS,
    "m": 60 * NANOS,
    "h": 3600 * NANOS,
    "d": 24 * 3600 * NANOS,
}

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h|d)")


def parse_duration(s: str) -> int:
    """Go-style duration ("10s", "1m30s", "2d") → nanos."""
    if not s:
        raise ValueError("empty duration")
    pos = 0
    total = 0
    while pos < len(s):
        m = _DUR_RE.match(s, pos)
        if not m:
            raise ValueError(f"invalid duration {s!r}")
        total += int(float(m.group(1)) * _UNITS[m.group(2)])
        pos = m.end()
    return total


def format_duration(nanos: int) -> str:
    for unit in ("d", "h", "m", "s", "ms", "us", "ns"):
        u = _UNITS[unit]
        if nanos >= u and nanos % u == 0:
            return f"{nanos // u}{unit}"
    return f"{nanos}ns"


@dataclass(frozen=True, order=True)
class Resolution:
    window_nanos: int

    def __str__(self) -> str:
        return format_duration(self.window_nanos)


@dataclass(frozen=True, order=True)
class Retention:
    period_nanos: int

    def __str__(self) -> str:
        return format_duration(self.period_nanos)


@dataclass(frozen=True, order=True)
class StoragePolicy:
    resolution: Resolution
    retention: Retention

    def __str__(self) -> str:
        return f"{self.resolution}:{self.retention}"

    @staticmethod
    def parse(s: str) -> "StoragePolicy":
        parts = s.split(":")
        if len(parts) != 2:
            raise ValueError(f"invalid storage policy {s!r}")
        res = parts[0].split("@")[0]  # precision suffix accepted, implied
        return StoragePolicy(
            Resolution(parse_duration(res)), Retention(parse_duration(parts[1]))
        )


def parse_policy(s: str) -> StoragePolicy:
    return StoragePolicy.parse(s)
